"""The port's GNN examples (``examples/torch_*.py``) on the CPU, against
the reference's examples run on the same inputs.

The reference's ``quickstart.py``, ``serve_gnn.py`` and
``serve_gnn_dist.py`` run in one subprocess (jax on the CPU, 4 forced
host devices, each example's own sizes) while the port's run here; each
line a reference example prints must be printed by the port's (a line the
reference ends with its own device's timing is held up to that part).
The reference's sharded serving example stops after its fourth line here:
its fast path fails in jax 0.9.0 (ROADMAP "Reference caveats"), so the
port's last two lines are held to what they state (no rounds, the same
bits, no stale answer), not to the reference's output.
``distributed_gat.py`` is cut for the CPU (module-level sizes patched) and
held to the reference's byte models, which are exact.

The LM serving examples (``torch_serve_lm.py``, ``torch_batch_serve.py``)
run beside the reference's ``serve_lm.py`` and ``batch_serve.py`` (in this
process, jax on the CPU) on the same weights (``init_params(0, ...)``, bit
for bit): ``serve_lm`` draws the reference's prompt itself
(``threefry.randint`` of ``jax.random.randint(key(1), ...)``, and the
frame embeddings with ``normal``), ``batch_serve``'s prompts are fixed.
The generated ids, and every line but the timings, are held equal.
"""
import importlib.util
import json
import os
import re
import runpy
import subprocess
import sys
from pathlib import Path

import pytest

from repro.configs.gnn import small_gnn_config as ref_config
from repro.core import aep as ref_aep
from repro.train.gnn_trainer import layer_dims as ref_layer_dims

REPO = Path(__file__).resolve().parents[1]
NAMES = ("quickstart", "serve_gnn", "serve_gnn_dist")
# the reference line's tail that is its own device's timing
TIMED = {"AEP overlap:": " (push "}

_REFERENCE = r"""
import contextlib, io, json, os, runpy, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
out = {}
for name in NAMES:
    buf = io.StringIO()
    sys.argv = [name + ".py"]
    error = None
    try:
        with contextlib.redirect_stdout(buf):
            runpy.run_path(os.path.join(EXAMPLES, name + ".py"),
                           run_name="__main__")
    except Exception as e:
        error = f"{type(e).__name__}: {e}"[:500]
    out[name] = {"lines": buf.getvalue().splitlines(), "error": error}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    """Starts the reference's examples; returns a function that waits for
    them and gives ``{"lines", "error"}`` of one."""
    code = (f"NAMES = {NAMES!r}\nEXAMPLES = {str(REPO / 'examples')!r}\n"
            + _REFERENCE)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    done = {}

    def result(name):
        if not done:
            out, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-3000:]
            done.update(json.loads(out.strip().splitlines()[-1]))
        return done[name]
    yield result
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def load_example(name: str):
    spec = importlib.util.spec_from_file_location(
        f"torch_{name}", REPO / "examples" / f"torch_{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def held_part(line: str) -> str:
    for head, tail in TIMED.items():
        if line.startswith(head) and tail in line:
            return line[:line.index(tail)]
    return line


@pytest.mark.parametrize("name", NAMES)
def test_example_prints_the_reference_lines(reference, name, capsys):
    """At the reference's sizes the port's example prints every line the
    reference's prints on the same graph, seeds and config."""
    load_example(name).main(["--device", "cpu"])
    out = capsys.readouterr().out
    ref = reference(name)
    if name == "serve_gnn_dist":
        # the reference's fast path: the repeat serve is all fast path
        assert ref["error"] and "Mapped away dimension" in ref["error"]
        assert len(ref["lines"]) == 4
        assert "repeat serve: rounds still 0, identical results: True" in out
        assert "no stale answers" in out
    else:
        assert ref["error"] is None, ref["error"]
    assert len(ref["lines"]) >= 4
    for line in ref["lines"]:
        assert held_part(line) in out, line


def test_distributed_gat_prints_the_byte_models(capsys):
    """The three modes train and evaluate (the graph and epochs cut for
    the CPU), and each prints the reference's byte model of its mode."""
    mod = load_example("distributed_gat")
    mod.VERTICES, mod.EPOCHS = 1500, 1
    mod.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    cfg = ref_config("gat", batch_size=128, feat_dim=32, num_classes=8,
                     lr=0.005)
    want = {
        "aep": ref_aep.aep_bytes_per_step(mod.RANKS, cfg.num_layers,
                                          cfg.hec.push_limit,
                                          ref_layer_dims(cfg)),
        "sync": ref_aep.sync_bytes_per_step(mod.RANKS, cfg.hec.push_limit,
                                            cfg.feat_dim),
        "drop": 0}
    assert lines[0] == ("minibatch pipeline: 1 prefetch workers, depth 1, "
                        "double-buffered staging")
    for mode, comm in want.items():
        row = [ln for ln in lines if ln.startswith(f"{mode:5s}: test_acc=")]
        assert len(row) == 1 and f"comm_bytes/step={comm}" in row[0]
    assert want["aep"] == 2_105_344 and want["sync"] == 139_264


LM_CASES = [("serve_lm", "minitron-4b"), ("serve_lm", "qwen2-vl-7b"),
            ("serve_lm", "seamless-m4t-medium"),
            ("batch_serve", "minitron-4b"), ("batch_serve", "mixtral-8x7b")]


def untimed(line: str) -> str:
    """A line up to its own device's timing (``0.52s`` and what follows)."""
    return re.sub(r" [\d.]+s( .*)?$", " ", line)


@pytest.mark.parametrize("name,arch", LM_CASES)
def test_lm_example_prints_the_reference_ids(name, arch, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", [f"{name}.py", "--arch", arch])
    runpy.run_path(str(REPO / "examples" / f"{name}.py"), run_name="__main__")
    want = capsys.readouterr().out.splitlines()
    load_example(name).main(["--arch", arch, "--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) >= 3
    for g, w in zip(got, want):
        assert untimed(g) == untimed(w), (g, w)
    ids = [ln for ln in got if ln.startswith(("generated ids:", "req "))]
    assert ids and all(ln in want for ln in ids)
