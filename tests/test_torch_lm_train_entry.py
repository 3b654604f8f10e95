"""The port's LM training entry points on the CPU against the
reference's: ``repro_torch.launch.train lm --device cpu --steps 3``
(minitron-4b and mixtral-8x7b, the reference launcher's other defaults)
and ``examples/torch_train_lm.py --steps 3 --batch 2 --seq 64 --device
cpu``, run here while the reference's ``launch/train.py lm`` and
``examples/train_lm.py`` run beside them in one subprocess (jax on the
CPU).  Both draw the same weights (``init_params(0, ...)``) and tokens
(``threefry``'s ``split``, ``randint``, ``fold_in`` and ``bernoulli``),
so every line is the reference's but the timings: a launcher's ``step``
lines and an example's lines up to their ``(... tok/s`` tail.  The
example's stream is also held bit for bit to ``synthetic_stream``.
"""
import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from _lm_train_parity import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
LAUNCH_ARCHS = ("minitron-4b", "mixtral-8x7b")
EXAMPLE_ARGS = ["--steps", "3", "--batch", "2", "--seq", "64"]

_REFERENCE = r"""
import contextlib, io, json, runpy, sys
from repro.launch import train
out = {}
for arch in ARCHS:
    buf = io.StringIO()
    sys.argv = ["train.py", "lm", "--arch", arch, "--steps", "3"]
    with contextlib.redirect_stdout(buf):
        train.main()
    out[arch] = buf.getvalue().splitlines()
buf = io.StringIO()
sys.argv = ["train_lm.py"] + EXAMPLE_ARGS
with contextlib.redirect_stdout(buf):
    runpy.run_path(EXAMPLE, run_name="__main__")
out["example"] = buf.getvalue().splitlines()
print(json.dumps(out))
"""


def _load_example():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_train_lm", REPO / "examples" / "torch_train_lm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def runs():
    code = (f"ARCHS = {LAUNCH_ARCHS!r}\nEXAMPLE_ARGS = {EXAMPLE_ARGS!r}\n"
            f"EXAMPLE = {str(REPO / 'examples' / 'train_lm.py')!r}\n"
            + _REFERENCE)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        from repro_torch.launch import train
        port = {}
        for arch in LAUNCH_ARCHS:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                train.main(["lm", "--arch", arch, "--steps", "3",
                            "--device", "cpu"])
            port[arch] = buf.getvalue().splitlines()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            _load_example().main(EXAMPLE_ARGS + ["--device", "cpu"])
        port["example"] = buf.getvalue().splitlines()
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.splitlines()[-1]), port


@pytest.mark.parametrize("arch", LAUNCH_ARCHS)
def test_launcher_lm_lines_are_the_references(runs, arch):
    ref, port = runs
    want = [ln for ln in ref[arch] if ln.startswith("step ")]
    got = [ln for ln in port[arch] if ln.startswith("step ")]
    assert len(want) == 3 and got == want
    assert any(ln.endswith(" steps in " + ln.split(" steps in ")[-1])
               for ln in port[arch] if ln.startswith("3 steps in "))


def test_example_lines_are_the_references(runs):
    ref, port = runs
    cut = lambda ln: ln.split(" (")[0]  # noqa: E731
    assert [cut(ln) for ln in port["example"]] == \
        [cut(ln) for ln in ref["example"]]
    assert all("tok/s on the CPU)" in ln for ln in port["example"]
               if ln.startswith("step "))


def test_example_stream_bit_for_bit():
    import jax.numpy as jnp
    import runpy
    ref = runpy.run_path(str(REPO / "examples" / "train_lm.py"))
    from repro_torch.pipeline import threefry
    for seed in (1, 9):
        k = jax.random.split(jax.random.key(seed))[1]
        want = np.asarray(ref["synthetic_stream"](k, 3, 40, 8192))
        tk = threefry.split(threefry.key(seed))[1]
        got = _load_example().synthetic_stream(tk, 3, 40, 8192).numpy()
        assert np.array_equal(got, want)
    assert jnp is not None


def test_lm_entry_points_default_to_the_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is valid")
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["lm", "--arch", "minitron-4b", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load_example().main(["--steps", "1"])


def test_normal_over_chunks_bit_for_bit():
    """``models/normal.py:normal`` past one ``CHUNK`` (its erf_inv on a
    thread pool) is ``jax.random.normal``'s draw bit for bit."""
    from repro_torch.models import normal as N
    from repro_torch.pipeline import threefry
    shape = (3, N.CHUNK + 77)
    want = np.asarray(jax.random.normal(jax.random.key(11), shape))
    got = N.normal(threefry.key(11), shape)
    assert got.dtype == want.dtype and np.array_equal(
        got.view(np.uint32), want.view(np.uint32))
