"""The port's dry run (``repro_torch/launch/gnn_dryrun.py``), its step
cost (``repro_torch/utils/step_cost.py``) and the analytic models it
prints (``core/aep.py``, ``comm/plan.py``), held to the reference.

The reference's dry run lowers its shard_map step and reads the cost off
the HLO (``repro/utils/hlo_cost.py``); it runs here in one subprocess (4
forced host devices) at ``--ranks 4 --vertices 4000`` for GraphSAGE
``aep``, GraphSAGE ``sync`` and GAT ``aep``, and the port's dry run at the
same flags on the CPU (the kernels' plain versions, counted by the
kernels' work formulas).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.comm.plan import build_exchange_plan as ref_build_plan
from repro.comm.plan import partition_degrees as ref_degrees
from repro.core import aep as ref_aep
from repro.graph import partition_graph as ref_partition
from repro.graph import synthetic_graph as ref_synthetic
from repro_torch.comm.plan import build_exchange_plan
from repro_torch.core import aep
from repro_torch.graph import partition_graph, synthetic_graph
from repro_torch.launch import gnn_dryrun

REPO = Path(__file__).resolve().parents[1]
RUNS = {"graphsage-aep": ("graphsage", "aep"),
        "graphsage-sync": ("graphsage", "sync"),
        "gat-aep": ("gat", "aep")}

_REFERENCE = r"""
import json, os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, numpy as np
from repro.configs.gnn import HECConfig, small_gnn_config
from repro.graph import partition_graph, synthetic_graph
from repro.launch.mesh import make_gnn_mesh
from repro.pipeline import MinibatchPipeline
from repro.train.gnn_trainer import DistTrainer, build_dist_data
from repro.utils import hlo_cost
R = 4
g = synthetic_graph(num_vertices=4000, avg_degree=10, num_classes=16,
                    feat_dim=128, seed=0)
ps = partition_graph(g, R, seed=0)
out = {}
for name, (model, mode) in RUNS.items():
    cfg = small_gnn_config(
        model, batch_size=256, feat_dim=128, num_classes=16, fanouts=(5, 10),
        hidden_size=256, hec=HECConfig(cache_size=65_536, ways=8,
                                       life_span=2, push_limit=1024, delay=1))
    dd = build_dist_data(ps, cfg)
    tr = DistTrainer(cfg=cfg, mesh=make_gnn_mesh(R), num_ranks=R, mode=mode)
    state = tr.init_state(jax.random.key(0), dd)
    pipe = MinibatchPipeline(ps, cfg, base_seed=0)
    mb = jax.device_put(pipe.plan.sample_host(0, 0,
                                              pipe.plan.epoch_schedule(0)[0]))
    compiled = tr.make_step(donate=False).lower(
        state["params"], state["opt_state"], state["hec"], state["hot"],
        state["inflight"], dd, mb, np.uint32(0)).compile()
    r = hlo_cost.analyze(compiled.as_text())
    r["param_bytes"] = sum(int(np.prod(x.shape)) * 4 for x in
                           jax.tree_util.tree_leaves(state["params"]))
    out[name] = r
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    """The reference's per-device cost of the three steps."""
    code = f"RUNS = {RUNS!r}\n" + _REFERENCE
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def port():
    """The port's dry runs at the same flags, on the CPU."""
    return {name: gnn_dryrun.run(["--ranks", "4", "--vertices", "4000",
                                  "--model", model, "--mode", mode,
                                  "--device", "cpu"])
            for name, (model, mode) in RUNS.items()}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_collective_schedule_is_the_reference(reference, port, name):
    """The all_to_all schedule exactly: GraphSAGE ``aep`` one op of
    8,421,376 B a rank (``aep_bytes_per_step(4, 2, 1024, [128, 256])``),
    ``sync`` two ops of 2,129,920 B in all (request tags and the feature
    responses), GAT ``aep`` one of 33,587,200 B (dmax 4 x 256)."""
    want = reference[name]["collectives"]["all-to-all"]
    got = port[name]["cost"]["collectives"]["all-to-all"]
    assert (got["count"], got["bytes"]) == (want["count"], want["bytes"])
    expect = {"graphsage-aep": (1, 8_421_376),
              "graphsage-sync": (2, 2_129_920),
              "gat-aep": (1, 33_587_200)}[name]
    assert (got["count"], got["bytes"]) == expect
    if name.endswith("aep"):
        assert got["bytes"] == port[name]["push_model_bytes"]


@pytest.mark.parametrize("name", sorted(RUNS))
def test_allreduce_is_the_gradient_and_the_metrics(reference, port, name):
    """The gradient all-reduce moves every parameter once in both; the
    rest are the step's scalar metrics, which differ in number and width
    (the reference fuses them into one tuple of 4-byte scalars, the port
    sums each, counts as int64): equal within the port's scalar bytes."""
    ref = reference[name]
    params = ref["param_bytes"]
    got = port[name]["cost"]["collectives"]["all-reduce"]["bytes"]
    want = ref["collectives"]["all-reduce"]["bytes"]
    scalars = got - params
    assert 0 < scalars <= 128 and 0 < want - params <= 128
    assert abs(got - want) <= scalars


@pytest.mark.parametrize("name,tol", [("graphsage-aep", 0.02),
                                      ("graphsage-sync", 0.02),
                                      ("gat-aep", 0.12)])
def test_flops_match_the_reference(reference, port, name, tol):
    """Per-rank flops within ``tol`` of the reference's HLO count.  The
    products are the same (UPDATE's two products forward, its weight and
    input products backward, GAT's projection); the terms that differ:
    (1) the reference counts dot products only, the port adds its
    kernels' own arithmetic (UPDATE's epilogue, AGG's adds and divisions,
    the HEC probe's compares, the edge softmax); (2) GAT: the port takes
    the attention logits as one product with a block matrix ``[H*dh, 2H]``
    (H times the reference's two per-head contractions) and its G and H
    work over the included slots, where the reference's einsums run over
    every slot."""
    got = port[name]["cost"]["flops"]
    want = reference[name]["flops"]
    assert abs(got - want) <= tol * want


def test_dryrun_prints_the_reference_lines(capsys):
    """The CLI prints the reference's report lines (with the build and
    first step in place of lower+compile) and the AEP assertion holds."""
    gnn_dryrun.main(["--ranks", "2", "--vertices", "1500", "--device",
                     "cpu"])
    out = capsys.readouterr().out
    for line in ("partitioned V=1500 into 2 ranks", "pipeline minibatch",
                 "build + first step at 2 ranks", "device memory: not",
                 "per-device per-step: flops=", "collective schedule:",
                 "roofline (NVIDIA H100", "AEP fused all_to_all: 1 op(s)",
                 "overlap (one card", "overlap (across cards, NVLink)",
                 "device time not measured", "health: per-rank halo rows",
                 "epoch breakdown"):
        assert line in out, line


def test_aep_models_are_the_reference():
    """``aep_bytes_per_step``, ``sync_bytes_per_step`` and
    ``epoch_time_model`` give the reference's numbers."""
    for R, L, nc, dims in ((4, 2, 1024, [128, 256]), (64, 2, 1024,
                                                      [128, 1024]),
                           (8, 3, 2000, [128, 256, 256])):
        assert aep.aep_bytes_per_step(R, L, nc, dims) == \
            ref_aep.aep_bytes_per_step(R, L, nc, dims)
        assert aep.sync_bytes_per_step(R, nc, dims[0]) == \
            ref_aep.sync_bytes_per_step(R, nc, dims[0])
    assert aep.aep_bytes_per_step(64, 2, 1024, [128, 256]) == 134_742_016
    for overlap in (True, False):
        for args in ((64, 120, 0.01, 134_742_016), (4, 10, 1e-3, 8e6)):
            assert aep.epoch_time_model(*args, overlap=overlap) == \
                ref_aep.epoch_time_model(*args, overlap=overlap)
            assert aep.epoch_time_model(*args, link_bw=450e9,
                                        overlap=overlap) == \
                ref_aep.epoch_time_model(*args, link_bw=450e9,
                                         overlap=overlap)


@pytest.mark.parametrize("hot_size", [0, 64])
def test_exchange_plan_models_are_the_reference(hot_size):
    """``halo_rows_total``, ``hot_rows_total``, ``exchange_bytes`` and
    ``modeled_remote_rows`` equal the reference's on the same partition."""
    g = synthetic_graph(num_vertices=3000, avg_degree=8, num_classes=8,
                        feat_dim=16, seed=2)
    rg = ref_synthetic(num_vertices=3000, avg_degree=8, num_classes=8,
                       feat_dim=16, seed=2)
    plan = build_exchange_plan(partition_graph(g, 4, seed=0),
                               hot_size=hot_size)
    rps = ref_partition(rg, 4, seed=0)
    ref = ref_build_plan(rps, hot_size=hot_size)
    for i in range(4):
        for j in range(4):
            assert np.array_equal(plan.ps.db_halo(i, j),
                                  ref.db_halo[i, j, :ref.pair_rows[i, j]])
    assert plan.halo_rows_total == ref.halo_rows_total
    assert plan.hot_rows_total == ref.hot_rows_total
    for dim, item in ((128, 4), (256, 2)):
        assert plan.exchange_bytes(dim, item) == ref.exchange_bytes(dim, item)
    deg = ref_degrees(rps)
    for rounds, every in ((1, 1), (10, 3)):
        assert plan.modeled_remote_rows(deg, rounds, every) == \
            ref.modeled_remote_rows(deg, rounds, every)
