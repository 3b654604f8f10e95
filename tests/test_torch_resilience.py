"""The port's resilience plane against the reference, on the CPU: fault
injection, the NaN/Inf step guard, full-state checkpoints and resume,
and sharded-serving failover.

The host pieces (schedules, the injector's bitmasks, the breaker, the
checkpoint manager, the prefetch retry) are held to the reference's own
classes in this process.  One reference subprocess with two forced host
devices runs the reference's ``tests/test_resilience.py`` training graph
(at ``batch_size=16``: four steps an epoch) through its ``train_epochs``
under a chaos schedule, recording every step's metrics, per-rank push
rows and HEC tags and ages, and writes its epoch checkpoints.

Tolerances: integer outputs bit for bit (skipped steps, events, HEC tags
and ages, pushed rows, Adam's count, archive leaves); the loss within
1e-5 relative and the parameters within rtol/atol 1e-4 (torch and XLA
sum float32 in other orders); NaN exactly where the reference has it.
The port against itself bit for bit: armed and clean against unarmed,
a chaos run against its replay, a killed prefetch worker against no
kill, and a fresh process that restores a checkpoint and trains on
against the run that never stopped.

The reference's sharded-failover test fails here on the jax vmap caveat
(ROADMAP.md), so the port is held to that test's own contract
(``tests/test_resilience.py``: failover-off bits with every rank alive,
the offline rows for a dead rank's hub queries, zeros for its cold ones,
the counters and events, exact answers after the re-probe).
"""
import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import resilience as jrz
from repro.configs.gnn import HECConfig as JHECConfig
from repro.configs.gnn import small_gnn_config as j_small_config
from repro.graph import partition_graph as j_partition_graph
from repro.graph import synthetic_graph as j_synthetic_graph
from repro.train import checkpoint as j_ckpt
from repro.train.gnn_trainer import DistTrainer as JDistTrainer
from repro.train.gnn_trainer import build_dist_data as j_build
from repro_torch import obs
from repro_torch import resilience as rz
from repro_torch.configs.gnn import HECConfig, small_gnn_config
from repro_torch.graph import partition_graph, synthetic_graph
from repro_torch.models.gnn import build_model
from repro_torch.pipeline.prefetcher import prefetch
from repro_torch.pipeline.staging import MinibatchPipeline
from repro_torch.serve.gnn import ServeCacheConfig
from repro_torch.serve.gnn.distributed import (DistGNNServeScheduler,
                                               DistServeConfig,
                                               layerwise_embeddings_dist)
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.gnn_trainer import DistTrainer, build_dist_data

REPO = Path(__file__).resolve().parents[1]
R = 2
EPOCHS = 4
CHAOS = [{"kind": "nan_step", "epoch": 1, "step": 0, "rank": 1},
         {"kind": "drop_push", "epoch": 2, "step": 1, "rank": 0},
         {"kind": "corrupt_push", "epoch": 2, "step": 0, "rank": 1},
         {"kind": "delay_rank", "epoch": 3, "step": 0, "rank": 0,
          "seconds": 0.01}]


def bits(a):
    a = np.asarray(a.detach().cpu() if isinstance(a, torch.Tensor) else a)
    return a.view(np.int32) if a.dtype == np.float32 else a


# ---------------------------------------------------------------------------
# schedules, the injector, the breaker: against the reference's classes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 11, 12])
def test_fault_schedule_sample_matches_reference(seed):
    """The same seed draws the reference's specs; JSON round-trips."""
    kw = dict(num_epochs=4, steps_per_epoch=3, num_ranks=4, seed=seed)
    got = rz.FaultSchedule.sample(8, **kw)
    assert got.to_dicts() == jrz.FaultSchedule.sample(8, **kw).to_dicts()
    again = rz.FaultSchedule.from_dicts(got.to_dicts())
    assert again.to_dicts() == got.to_dicts()
    assert got.has_device_faults == jrz.FaultSchedule.sample(
        8, **kw).has_device_faults
    with pytest.raises(ValueError):
        rz.FaultSpec(kind="meteor_strike", epoch=0, step=0)


def test_step_codes_match_reference(tmp_path):
    """Bitmasks, events and the delay's sleep as the reference's."""
    specs = CHAOS + [{"kind": "nan_step", "epoch": 0, "step": 1, "rank": 0},
                     {"kind": "drop_push", "epoch": 0, "step": 1, "rank": 5},
                     {"kind": "corrupt_push", "epoch": 0, "step": 1,
                      "rank": 1}]
    path = tmp_path / "faults.json"
    path.write_text(json.dumps(specs))
    got = rz.FaultInjector(rz.FaultSchedule.from_json(str(path)))
    want = jrz.FaultInjector(jrz.FaultSchedule.from_json(str(path)))
    for ep in range(4):
        for step in range(3):
            t0 = time.perf_counter()
            a = got.step_codes(ep, step, 2)
            dt = time.perf_counter() - t0
            b = want.step_codes(ep, step, 2)
            assert a.dtype == b.dtype == np.int32
            assert np.array_equal(a, b), (ep, step)
            if (ep, step) == (3, 0):
                assert dt >= 0.01
    assert got.events == want.events and len(got.events) == 7
    assert (rz.CODE_NAN_STEP, rz.CODE_DROP_PUSH, rz.CODE_CORRUPT_PUSH) == \
        (jrz.CODE_NAN_STEP, jrz.CODE_DROP_PUSH, jrz.CODE_CORRUPT_PUSH)


def test_prefetch_crash_fires_once():
    inj = rz.FaultInjector(rz.FaultSchedule([
        rz.FaultSpec("kill_prefetch", epoch=2, step=1)]))
    inj.prefetch_crash(0, 0)
    with pytest.raises(rz.PrefetchWorkerKilled):
        inj.prefetch_crash(2, 1)
    inj.prefetch_crash(2, 1)                 # the retry draws the batch
    assert inj.events == [{"kind": "kill_prefetch", "epoch": 2, "step": 1,
                           "rank": 0}]


def test_breaker_matches_reference():
    """One scripted sequence of failures, ticks and probes: the port's
    breaker reaches the reference's state, opening round and failure
    count after every call, and returns the same recoveries."""
    ops = [("fail", 1, 0), ("fail", 1, 0), ("tick", 1, None),
           ("tick", 2, False), ("fail", 0, 2), ("fail", 0, 2),
           ("tick", 3, True), ("tick", 4, True), ("open", 2, 4),
           ("tick", 5, False), ("tick", 6, None), ("fail", 2, 6),
           ("tick", 8, True)]
    got = rz.RankHealthMask(3, cooldown=2, threshold=2)
    want = jrz.RankHealthMask(3, cooldown=2, threshold=2)
    for op, a, b in ops:
        if op == "fail":
            out = (got.record_failure(a, b), want.record_failure(a, b))
        elif op == "open":
            out = (got.force_open(a, b), want.force_open(a, b))
        else:
            probe = None if b is None else (lambda r, ok=b: ok)
            out = (got.tick(a, probe), want.tick(a, probe))
        assert out[0] == out[1], (op, a, b)
        for f in ("state", "opened_at", "failures"):
            assert np.array_equal(getattr(got, f), getattr(want, f)), f
        assert got.dead_ranks == want.dead_ranks
        assert np.array_equal(got.alive, want.alive)


def test_hung_probe_counts_as_dead():
    assert rz.probe_with_timeout(lambda r: True, 0, 1.0)
    assert not rz.probe_with_timeout(lambda r: False, 0, 1.0)
    assert not rz.probe_with_timeout(
        lambda r: (_ for _ in ()).throw(RuntimeError("boom")), 0, 1.0)
    assert not rz.probe_with_timeout(
        lambda r: time.sleep(2.0) or True, 0, 0.05)
    m = rz.RankHealthMask(2, cooldown=0)
    m.force_open(1, 0)
    assert m.tick(0, probe=lambda r: time.sleep(2.0) or True,
                  timeout_s=0.05) == []
    assert m.dead_ranks == [1]


# ---------------------------------------------------------------------------
# the prefetch retry
# ---------------------------------------------------------------------------
def test_prefetch_retries_a_failed_step_once():
    fired = set()

    def make(step):
        if step == 1 and step not in fired:
            fired.add(step)
            raise RuntimeError("worker died")
        return {"step": step}

    before = obs.get().registry.value("prefetch_retries")
    got = [b["step"] for b in prefetch(make, 4, num_workers=2, depth=2)]
    assert got == [0, 1, 2, 3]
    assert obs.get().registry.value("prefetch_retries") - before == 1


@pytest.mark.parametrize("workers", [2, 0])
def test_prefetch_second_failure_propagates(workers):
    """A step that fails again (or at all inline, which has no retry)
    raises."""
    def make(step):
        if step == 2:
            raise RuntimeError("hard bug, not a flake")
        return step

    before = obs.get().registry.value("prefetch_retries")
    with pytest.raises(RuntimeError, match="hard bug"):
        list(prefetch(make, 4, num_workers=workers, depth=2))
    assert obs.get().registry.value("prefetch_retries") - before == \
        (1 if workers else 0)


# ---------------------------------------------------------------------------
# training: the port's side
# ---------------------------------------------------------------------------
def graph():
    return synthetic_graph(num_vertices=1200, avg_degree=6, num_classes=8,
                           feat_dim=32, seed=5)


def config(model="graphsage", **hot):
    return small_gnn_config(model, batch_size=16, feat_dim=32, num_classes=8,
                            fanouts=(4, 8), hidden_size=64,
                            hec=HECConfig(cache_size=2048, ways=8,
                                          life_span=2, push_limit=256,
                                          delay=1, **hot))


@pytest.fixture(scope="module")
def world():
    ps = partition_graph(graph(), R, seed=0)
    out = {"ps": ps}
    for model in ("graphsage", "gat"):
        cfg = config(model)
        out[model] = (cfg, build_dist_data(ps, cfg, "cpu"))
    return out


def digest(state) -> str:
    h = hashlib.sha256()
    for leaf in ckpt.state_leaves(state):
        h.update(bits(leaf).tobytes())
    return h.hexdigest()


def train(world, model="graphsage", plane=None, epochs=EPOCHS, record=False):
    """A port run from the reference's initial weights; with ``record``
    every step's per-rank push rows and HEC tags and ages."""
    cfg, data = world[model]
    tr = DistTrainer(cfg, R, device="cpu", resilience=plane)
    st = tr.init_state(seed=0)
    steps = []
    if record:
        step = tr.train_step

        def recorded(*a, **k):
            m = step(*a, **k)
            steps.append({
                "push_rows": tr.rank_stats["rank_push_rows"].copy(),
                "tags": [np.stack([s.tags.numpy() for s in layer])
                         for layer in st["hec"]],
                "age": [np.stack([s.age.numpy() for s in layer])
                        for layer in st["hec"]]})
            return m
        tr.train_step = recorded
    st, hist = tr.train_epochs(world["ps"], data, st, epochs)
    return tr, st, steps


def chaos_plane(flight_dir, **kw):
    return rz.ResiliencePlane(rz.ResilienceConfig(
        nan_guard=True, schedule=rz.FaultSchedule.from_dicts(CHAOS),
        flight_dir=str(flight_dir), **kw))


@pytest.fixture(scope="module")
def base(world):
    return {m: train(world, m) for m in ("graphsage", "gat")}


@pytest.fixture(scope="module")
def chaos_runs(world, tmp_path_factory):
    runs = []
    for _ in range(2):
        d = tmp_path_factory.mktemp("chaos")
        plane = chaos_plane(d)
        tr, st, steps = train(world, plane=plane, record=True)
        runs.append((plane, tr, st, steps, d))
    return runs


@pytest.mark.parametrize("model", ["graphsage", "gat"])
def test_armed_and_clean_is_unarmed(world, base, model):
    """The guard armed with every fault code 0: the unarmed run's bits,
    every metric but ``skipped`` (always 0) equal."""
    plane = rz.ResiliencePlane(rz.ResilienceConfig(nan_guard=True))
    tr, st, _ = train(world, model, plane)
    b_tr, b_st, _ = base[model]
    assert digest(st) == digest(b_st)
    assert [m.pop("skipped") for m in tr.step_log] == [0.0] * len(
        tr.step_log)
    assert tr.step_log == b_tr.step_log
    assert plane.skipped_steps == 0 and plane.finalize() is None


def test_chaos_run_repeats_bit_for_bit(world, base, chaos_runs):
    """The chaos schedule: every spec fires, the poisoned step and the
    steps that read the corrupt push are skipped, the parameters stay
    finite, FLIGHT_resilience.json is written and the replay is equal
    bit for bit."""
    (p1, t1, s1, _, d1), (p2, t2, s2, _, _) = chaos_runs
    assert digest(s1) == digest(s2)
    assert p1.skipped_steps == p2.skipped_steps >= 1
    assert len(p1.events) == 4
    assert digest(s1) != digest(base["graphsage"][1])
    assert all(bool(torch.isfinite(p).all())
               for p in s1["model"].parameter_list())
    blob = json.load(open(d1 / "FLIGHT_resilience.json"))
    assert blob["skipped_steps"] == p1.skipped_steps
    assert [m["skipped"] for m in t1.step_log] == \
        [m["skipped"] for m in t2.step_log]


def test_skipped_step_keeps_state(world):
    """A step with rank 1's nan_step code: parameters and both moments as
    before it, Adam's count not advanced (the step counter is), the
    metrics zero with ``skipped`` 1, the poisoned rank's rows all
    filtered from the push; the next clean step advances the count."""
    cfg, data = world["graphsage"]
    plane = rz.ResiliencePlane(rz.ResilienceConfig(nan_guard=True))
    tr = DistTrainer(cfg, R, device="cpu", resilience=plane)
    st = tr.init_state(seed=0)
    mb = next(MinibatchPipeline(world["ps"], cfg, device="cpu")
              .epoch_batches(0))

    def tensors():
        return st["model"].parameter_list() + st["opt"].mu + st["opt"].nu
    before = [t.detach().clone() for t in tensors()]
    m = tr.train_step(st, data, mb, 0,
                      np.array([0, rz.CODE_NAN_STEP], np.int32))
    assert m["skipped"] == 1.0
    assert m["loss"] == m["acc"] == m["examples"] == m["grad_norm"] == 0.0
    assert (st["opt"].step, st["step"]) == (0, 1)
    assert all(torch.equal(a, b) for a, b in zip(tensors(), before))
    assert int(tr.rank_stats["rank_push_rows"][1]) == 0
    assert int(tr.rank_stats["rank_push_rows"][0]) > 0
    m = tr.train_step(st, data, mb, 1)
    assert m["skipped"] == 0.0 and st["opt"].step == 1
    assert not all(torch.equal(a, b) for a, b in zip(tensors(), before))


def test_killed_prefetch_costs_one_retry(world, base, tmp_path):
    before = obs.get().registry.value("prefetch_retries")
    plane = rz.ResiliencePlane(rz.ResilienceConfig(
        schedule=rz.FaultSchedule([rz.FaultSpec("kill_prefetch", 0, 1)]),
        flight_dir=str(tmp_path)))
    _, st, _ = train(world, plane=plane)
    assert obs.get().registry.value("prefetch_retries") - before == 1
    assert digest(st) == digest(base["graphsage"][1])
    assert plane.events == [{"kind": "kill_prefetch", "epoch": 0, "step": 1,
                             "rank": 0}]


_RESUME = r"""
import hashlib, json, sys
import numpy as np
import torch
from repro_torch import resilience as rz
from repro_torch.configs.gnn import HECConfig, small_gnn_config
from repro_torch.graph import partition_graph, synthetic_graph
from repro_torch.train.checkpoint import state_leaves
from repro_torch.train.gnn_trainer import DistTrainer, build_dist_data
R = 2
ps = partition_graph(synthetic_graph(num_vertices=1200, avg_degree=6,
                                     num_classes=8, feat_dim=32, seed=5),
                     R, seed=0)
cfg = small_gnn_config("graphsage", batch_size=16, feat_dim=32,
                       num_classes=8, fanouts=(4, 8), hidden_size=64,
                       hec=HECConfig(cache_size=2048, ways=8, life_span=2,
                                     push_limit=256, delay=1))


def digest(state):
    h = hashlib.sha256()
    for leaf in state_leaves(state):
        a = np.asarray(leaf.detach() if isinstance(leaf, torch.Tensor)
                       else leaf)
        h.update((a.view(np.int32) if a.dtype == np.float32 else a)
                 .tobytes())
    return h.hexdigest()


plane = rz.ResiliencePlane(rz.ResilienceConfig(ckpt_dir=sys.argv[1]))
tr = DistTrainer(cfg, R, device="cpu", resilience=plane)
st = tr.init_state(seed=0)
st, ep = plane.ckpt.restore(st)
st, _ = tr.train_epochs(ps, build_dist_data(ps, cfg, "cpu"), st,
                        int(sys.argv[2]) - (ep + 1), start_epoch=ep + 1)
print("RESULT" + json.dumps({"epoch": ep, "digest": digest(st),
                             "step": st["step"], "adam": st["opt"].step}))
"""


def test_kill_and_resume_in_a_fresh_process(world, base, tmp_path):
    """Two epochs with epoch checkpoints, then a fresh process restores
    LATEST and trains epochs 2-3: the uninterrupted run's bits."""
    d = tmp_path / "ck"
    plane = rz.ResiliencePlane(rz.ResilienceConfig(ckpt_dir=str(d),
                                                   ckpt_keep=3))
    train(world, plane=plane, epochs=2)
    assert sorted(os.listdir(d)) == ["LATEST", "ckpt_ep00000.npz",
                                     "ckpt_ep00001.npz"]
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _RESUME, str(d), str(EPOCHS)], env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [x for x in proc.stdout.splitlines() if x.startswith("RESULT")]
    got = json.loads(line[-1][len("RESULT"):])
    b_tr, b_st, _ = base["graphsage"]
    assert got["epoch"] == 1
    assert got["digest"] == digest(b_st)
    assert got["step"] == b_st["step"] and got["adam"] == b_st["opt"].step


def test_checkpoint_manager(world, tmp_path):
    """Retention, LATEST, the directory-scan fallback, an empty
    directory's FileNotFoundError and the typed mismatch error (nothing
    written into the state before it)."""
    cfg, _ = world["graphsage"]
    tr = DistTrainer(cfg, R, device="cpu")
    st = tr.init_state(seed=0)
    d = str(tmp_path / "ck")
    mgr = rz.CheckpointManager(d, every=2, keep=2)
    assert [mgr.should_save(e) for e in range(4)] == [False, True, False,
                                                      True]
    for ep in (1, 3, 5):
        st["step"] = ep
        assert mgr.save(st, ep) == mgr.path_for(ep)
    assert sorted(n for n in os.listdir(d) if n.endswith(".npz")) == \
        ["ckpt_ep00003.npz", "ckpt_ep00005.npz"]
    assert not [n for n in os.listdir(d) if n.endswith(".tmp")]
    assert mgr.latest() == (mgr.path_for(5), 5)
    os.remove(os.path.join(d, "LATEST"))
    assert mgr.latest() == (mgr.path_for(5), 5)
    st["step"] = 0
    got, ep = mgr.restore(st)
    assert got is st and ep == 5 and st["step"] == 5
    assert rz.CheckpointManager(str(tmp_path / "empty")).latest() is None
    with pytest.raises(FileNotFoundError):
        rz.CheckpointManager(str(tmp_path / "empty")).restore(st)
    other = DistTrainer(small_gnn_config(
        "graphsage", batch_size=16, feat_dim=32, num_classes=8,
        fanouts=(4, 8), hidden_size=48), R, device="cpu")
    ost = other.init_state(seed=1)
    keep = [p.detach().clone() for p in ost["model"].parameter_list()]
    with pytest.raises(ckpt.CheckpointMismatchError):
        mgr.restore(ost)
    assert all(torch.equal(a, b) for a, b in
               zip(ost["model"].parameter_list(), keep))
    few = dict(st, hec=st["hec"][:1])
    with pytest.raises(ckpt.CheckpointMismatchError, match="leaves"):
        ckpt.restore(mgr.path_for(5), few)


def test_plane_disarmed_is_inert(tmp_path):
    plane = rz.ResiliencePlane(rz.ResilienceConfig())
    assert not plane.step_armed and plane.ckpt is None
    assert not plane.step_codes(0, 0, 4).any() and plane.finalize() is None
    armed = rz.ResiliencePlane(rz.ResilienceConfig(
        nan_guard=True, flight_dir=str(tmp_path)))
    armed.on_step(3, 1, skipped=1.0)
    path = armed.finalize()
    assert os.path.basename(path) == "FLIGHT_resilience.json"
    assert json.load(open(path))["skipped_steps"] == 1


# ---------------------------------------------------------------------------
# the reference's chaos run and archives
# ---------------------------------------------------------------------------
_REF_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import json
import jax
import numpy as np
from repro import resilience
from repro.configs.gnn import HECConfig, small_gnn_config
from repro.graph import partition_graph, synthetic_graph
from repro.launch.mesh import make_gnn_mesh
from repro.train.gnn_trainer import DistTrainer, build_dist_data

R = 2
work = sys.argv[1]
g = synthetic_graph(num_vertices=1200, avg_degree=6, num_classes=8,
                    feat_dim=32, seed=5)
ps = partition_graph(g, R, seed=0)
cfg = small_gnn_config("graphsage", batch_size=16, feat_dim=32,
                       num_classes=8, fanouts=(4, 8), hidden_size=64,
                       hec=HECConfig(cache_size=2048, ways=8, life_span=2,
                                     push_limit=256, delay=1))
dd = build_dist_data(ps, cfg)
plane = resilience.ResiliencePlane(resilience.ResilienceConfig(
    nan_guard=True, schedule=resilience.FaultSchedule.from_dicts(
        json.loads(sys.argv[2])),
    ckpt_dir=os.path.join(work, "ck"), ckpt_keep=1, flight_dir=work))
tr = DistTrainer(cfg=cfg, mesh=make_gnn_mesh(R), num_ranks=R, mode="aep",
                 resilience=plane)
state = tr.init_state(jax.random.key(0))
out = {}
step_fn = tr.make_step(dd)
n = [0]


def recorded(*args):
    res = step_fn(*args)
    i = n[0]
    hec, rank_stats, metrics = res[2], res[5], res[6]
    for k, v in metrics.items():
        out[f"m/{i}/{k}"] = np.asarray(v)
    out[f"push_rows/{i}"] = np.asarray(rank_stats["rank_push_rows"])
    for l, h in enumerate(hec):
        out[f"tags/{i}/{l}"] = np.asarray(h.tags)
        out[f"age/{i}/{l}"] = np.asarray(h.age)
    n[0] += 1
    return res


state, _ = tr.train_epochs(ps, dd, state, 4, step_fn=recorded)
out["steps"] = np.asarray(n[0])
out["skipped"] = np.asarray(plane.skipped_steps)
out["events"] = np.asarray(len(plane.events))
for j, leaf in enumerate(jax.tree_util.tree_leaves(state)):
    out[f"leaf/{j}"] = np.asarray(leaf)
np.savez(os.path.join(work, "ref.npz"), **out)
"""


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    work = tmp_path_factory.mktemp("ref")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", _REF_SCRIPT, str(work),
                           json.dumps(CHAOS)], env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return work, dict(np.load(work / "ref.npz"))


def test_chaos_run_matches_reference(chaos_runs, reference_run):
    """The port's chaos run step by step against the reference's: the
    skipped steps, the events, every step's HEC tags and ages and per-rank
    push rows equal, the losses within 1e-5, the final state's leaves
    (HEC values NaN where the reference's are) within 1e-4."""
    plane, tr, st, steps, _ = chaos_runs[0]
    _, ref = reference_run
    n = int(ref["steps"])
    assert len(tr.step_log) == len(steps) == n >= 12
    assert plane.skipped_steps == int(ref["skipped"]) >= 2
    assert len(plane.events) == int(ref["events"]) == 4
    for i, (m, s) in enumerate(zip(tr.step_log, steps)):
        assert m["skipped"] == float(ref[f"m/{i}/skipped"]), i
        assert m["aep_push_rows"] == float(ref[f"m/{i}/aep_push_rows"]), i
        np.testing.assert_allclose(m["loss"], float(ref[f"m/{i}/loss"]),
                                   rtol=1e-5, atol=1e-6)
        assert np.array_equal(s["push_rows"], ref[f"push_rows/{i}"]), i
        for l in range(2):
            assert np.array_equal(s["tags"][l], ref[f"tags/{i}/{l}"]), i
            assert np.array_equal(s["age"][l], ref[f"age/{i}/{l}"]), i
    leaves = ckpt.state_leaves(st)
    assert len(leaves) == sum(1 for k in ref if k.startswith("leaf/"))
    for j, leaf in enumerate(leaves):
        a = np.asarray(leaf.detach() if isinstance(leaf, torch.Tensor)
                       else leaf)
        b = ref[f"leaf/{j}"]
        assert a.shape == b.shape and a.dtype == b.dtype, j
        if a.dtype.kind == "f":
            assert np.array_equal(np.isnan(a), np.isnan(b)), j
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
        else:
            assert np.array_equal(a, b), j


def test_reference_archive_restores_into_the_port(world, reference_run):
    """The reference's epoch-3 checkpoint, restored into a fresh port
    state: every leaf the archive's bits, the training step and Adam's
    count included."""
    work, ref = reference_run
    cfg, _ = world["graphsage"]
    tr = DistTrainer(cfg, R, device="cpu")
    st = tr.init_state(seed=7)
    mgr = rz.CheckpointManager(str(work / "ck"))
    st, ep = mgr.restore(st)
    assert ep == 3
    for j, leaf in enumerate(ckpt.state_leaves(st)):
        assert np.array_equal(bits(leaf), bits(ref[f"leaf/{j}"])), j
    assert st["step"] == int(ref["steps"])
    assert st["opt"].step == int(ref["steps"]) - int(ref["skipped"])


@pytest.mark.parametrize("hot", [False, True])
def test_port_archive_restores_into_the_reference(world, chaos_runs, tmp_path,
                                                  hot):
    """The port's archive through ``repro.train.checkpoint.restore`` into
    the reference trainer's ``init_state`` tree: every leaf equal, bit
    for bit (the chaos run's NaN HEC lines; with the hot tier, two
    trained steps)."""
    if hot:
        cfg = config(hot_size=48, hot_budget=32)
        ps = world["ps"]
        data = build_dist_data(ps, cfg, "cpu")
        tr = DistTrainer(cfg, R, device="cpu")
        st = tr.init_state(seed=0, dist_data=data)
        for i, mb in zip(range(2), MinibatchPipeline(
                ps, cfg, device="cpu").epoch_batches(0)):
            tr.train_step(st, data, mb, i)
        assert st["hot"]
    else:
        st = chaos_runs[0][2]
    path = ckpt.save(str(tmp_path / "port.npz"), st, step=9)
    jcfg = j_small_config("graphsage", batch_size=16, feat_dim=32,
                          num_classes=8, fanouts=(4, 8), hidden_size=64,
                          hec=JHECConfig(cache_size=2048, ways=8,
                                         life_span=2, push_limit=256,
                                         delay=1, **(dict(
                                             hot_size=48, hot_budget=32)
                                             if hot else {})))
    jtr = JDistTrainer(cfg=jcfg, mesh=None, num_ranks=R)
    dd = None
    if hot:
        jps = j_partition_graph(j_synthetic_graph(
            num_vertices=1200, avg_degree=6, num_classes=8, feat_dim=32,
            seed=5), R, seed=0)
        dd = j_build(jps, jcfg)
    like = jtr.init_state(jax.random.key(0), dd)
    got, step = j_ckpt.restore(path, like)
    assert step == 9
    want = ckpt.state_leaves(st)
    have = jax.tree_util.tree_leaves(got)
    assert len(have) == len(want)
    for a, b in zip(have, want):
        assert np.array_equal(bits(np.asarray(a)), bits(b))


# ---------------------------------------------------------------------------
# sharded serving failover: the reference test's contract
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("model", ["graphsage", "gat"])
def test_sharded_failover_contract(model):
    """Failover on with every rank alive: failover off's bits.  Rank 1
    marked dead with a failing probe: its hub queries answer the offline
    rows bit for bit from alive replicas, its cold ones zeros, without a
    stall; the gauge is up.  A passing probe closes the breaker, after
    which its queries compute the offline rows again; one dead and one
    recovered event."""
    g = synthetic_graph(num_vertices=900, avg_degree=2, num_classes=5,
                        feat_dim=16, seed=3)
    part = partition_graph(g, 1, seed=0).parts[0]
    ps = partition_graph(g, 4, seed=0)
    max_deg = int((part.indptr[1:] - part.indptr[:-1]).max())
    cfg = small_gnn_config(model, batch_size=16, feat_dim=16, num_classes=5,
                           fanouts=(max_deg, max_deg), hidden_size=32)
    net = build_model(cfg, seed=0, device="cpu")
    ed = layerwise_embeddings_dist(cfg, net, ps, chunk_size=128)
    edL = ed[-1].numpy()
    L = cfg.num_layers

    def build(**kw):
        s = DistGNNServeScheduler(cfg, net, ps, DistServeConfig(
            num_slots=8, halo_slots=160, hot_size=96,
            cache=ServeCacheConfig(cache_size=8192, ways=4), **kw),
            device="cpu")
        s.cache.warm(ed, np.arange(900), layers=range(L - 1))
        s.hot.warm(ed)
        return s
    reg = obs.get().registry
    events = {k: len(list(reg.events_of(f"serve_rank_{k}")))
              for k in ("dead", "recovered")}
    vids = np.arange(0, 900, 7)
    off, on = build(), build(failover=True)
    assert np.array_equal(bits(on.serve(vids)), bits(off.serve(vids)))
    assert on.metrics()["serve_degraded"] == 0.0
    hot_vids = np.asarray(on.hot.hot_vids)
    owner, _ = ps.route(hot_vids)
    dead_hot = hot_vids[owner == 1][:6]
    hot_set = set(int(v) for v in hot_vids)
    cold = [int(v) for v in ps.parts[1].solid_vids if int(v) not in hot_set]
    on.probe_fn = lambda r: False
    on.mark_dead(1)
    ans = on.serve(np.concatenate([dead_hot, cold[:3]]))
    m = on.metrics()
    assert (m["serve_degraded"], m["dead_ranks"]) == (1.0, [1])
    assert m["degraded_answers"] >= 6 and m["degraded_dropped"] >= 3
    assert np.array_equal(bits(ans[:6]), bits(edL[dead_hot]))
    assert np.all(ans[6:] == 0.0)
    assert reg.value("serve_degraded") == 1.0
    on.serve(np.asarray(ps.parts[0].solid_vids[:8]))   # the round clock
    on.probe_fn = lambda r: True
    on.serve(np.asarray(ps.parts[2].solid_vids[:4]))
    m = on.metrics()
    assert (m["serve_degraded"], m["dead_ranks"]) == (0.0, [])
    assert reg.value("serve_degraded") == 0.0
    post = np.array(cold[3:9])
    assert np.abs(on.serve(post) - edL[post]).max() < 1e-5
    assert {k: len(list(reg.events_of(f"serve_rank_{k}"))) - v
            for k, v in events.items()} == {"dead": 1, "recovered": 1}
    with pytest.raises(RuntimeError, match="failover=True"):
        off.mark_dead(1)
    with pytest.raises(RuntimeError, match="failover=True"):
        off.record_rank_failure(1)


def test_record_rank_failure_opens_at_threshold():
    g = synthetic_graph(num_vertices=400, avg_degree=3, num_classes=4,
                        feat_dim=8, seed=1)
    ps = partition_graph(g, 2, seed=0)
    cfg = small_gnn_config("graphsage", batch_size=8, feat_dim=8,
                           num_classes=4, fanouts=(3, 3), hidden_size=8)
    s = DistGNNServeScheduler(cfg, build_model(cfg, seed=0, device="cpu"),
                              ps, DistServeConfig(failover=True,
                                                  breaker_threshold=2),
                              device="cpu")
    assert not s.record_rank_failure(0)
    assert s.record_rank_failure(0)
    assert s.metrics()["dead_ranks"] == [0]


# ---------------------------------------------------------------------------
# the launcher's flags
# ---------------------------------------------------------------------------
def test_launcher_resilience_flags(tmp_path, capsys):
    """``--fault-schedule`` + ``--nan-guard`` + ``--ckpt-dir``, then
    ``--resume`` for one more epoch equal to a straight run, and both
    exits; all on ``--device cpu``."""
    from repro_torch.launch import train as launch
    sched = tmp_path / "faults.json"
    sched.write_text(json.dumps([
        {"kind": "nan_step", "epoch": 0, "step": 1, "rank": 1},
        {"kind": "kill_prefetch", "epoch": 1, "step": 0}]))
    common = ["gnn", "--device", "cpu", "--ranks", "2", "--vertices", "1500",
              "--batch", "64", "--flight-dir", str(tmp_path / "fl")]
    ck = str(tmp_path / "ck")
    res = launch.run_gnn(launch.parse_args(
        common + ["--epochs", "2", "--ckpt-dir", ck, "--fault-schedule",
                  str(sched), "--nan-guard"]))
    out = capsys.readouterr().out
    assert "fault schedule: 2 scheduled faults" in out
    assert "resilience: faults_injected=2 skipped_steps=1 " in out
    assert res["resilience"].skipped_steps == 1
    assert (tmp_path / "fl" / "FLIGHT_resilience.json").exists()
    assert sorted(os.listdir(ck)) == ["LATEST", "ckpt_ep00000.npz",
                                      "ckpt_ep00001.npz"]
    res = launch.run_gnn(launch.parse_args(
        common + ["--epochs", "3", "--ckpt-dir", ck, "--resume"]))
    assert "resumed from epoch 1" in capsys.readouterr().out
    assert len(res["history"]) == 1
    with pytest.raises(SystemExit, match="nothing to train"):
        launch.run_gnn(launch.parse_args(
            common + ["--epochs", "2", "--ckpt-dir", ck, "--resume"]))
    with pytest.raises(SystemExit, match="--resume requires --ckpt-dir"):
        launch.run_gnn(launch.parse_args(common + ["--resume"]))
    plain = launch.run_gnn(launch.parse_args(common + ["--epochs", "1"]))
    assert plain["resilience"] is None
