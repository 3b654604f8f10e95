"""Distributed minibatch GNN training (GraphSAGE or GAT) in ``aep`` mode
(paper Algorithms 1 and 2) — counterpart of
``repro/train/gnn_trainer.py``.

One paper "rank" owns a graph partition, a HEC per layer and an AEP
in-flight queue; the model parameters are replicated and the gradients
all-reduced.  Here R ranks run in one process on one device: the step is
a sequence of stages over all ranks, with the collectives of a
:class:`~repro_torch.comm.collective.StackedCollective` between them,
where the reference runs one ``shard_map`` program per rank.

One step (``DistTrainer.train_step``, the reference's ``_rank_step``
without the hot tier and the fault codes):

  1. per rank, consume the delayed push: tick every layer's HEC and store
     the queue's slot 0 (in place);
  2. per rank, gather the layer-0 features and substitute HEC hits (the
     HEC probe + load kernel) for halo rows;
  3. per rank and layer, the model's layer with the hash dropout
     (GraphSAGE: the AGG and UPDATE kernels; GAT: the projection in
     ``torch.addmm`` and the GAT AGG kernel), then the halo hook: HEC hits
     replace halo rows by ``torch.where``, so substituted rows get no
     gradient;
  4. per rank, the masked cross-entropy over the seeds;
  5. the AEP push of every rank's selection in ONE fused all_to_all,
     between the forward and the backward (the paper's overlap); it reads
     detached forward activations;
  6. per rank, the backward (the layers' gradient kernels and
     ``torch.matmul``);
  7. the example-weighted gradient all-reduce;
  8. Adam with a global-norm clip of 1.0, in place.

With ``cfg.pipeline.sampler.device_draw`` the minibatches' fanout draw
runs on ``device`` (kernel I on the card); under the ``cv`` policy
``train_epochs`` refreshes each rank's HEC residency, which the draw's
weights read, at the start of every epoch.

The HEC states and the queues are updated in place where the reference
returns new ones; ``evaluate`` therefore works on copies (``hec_clone``)
and leaves the training state as it was.  The reference's ``sync`` and
``drop`` modes, the hot tier, the NaN guard and fault codes, and the
health and quality planes wait for later slices.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.cache import hec as hec_lib
from repro_torch.comm.collective import StackedCollective
from repro_torch.comm.engine import HaloExchangeEngine
from repro_torch.comm.plan import _pad_stack, build_exchange_plan
from repro_torch.configs.gnn import GNNConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.graph.partition import PartitionSet
from repro_torch.models.gnn import build_model
from repro_torch.pipeline import threefry
from repro_torch.pipeline.prefetcher import EVAL_EPOCH_TAG, SamplingPlan
from repro_torch.train import optimizer as opt_lib

PushUniforms = Callable[[int, int, Sequence[int]], torch.Tensor]


def layer_dims(cfg: GNNConfig) -> List[int]:
    """Embedding dim held in HEC_l for l = 0..L-1 (inputs + hidden)."""
    return [cfg.feat_dim] + [cfg.hidden_width] * (cfg.num_layers - 1)


def build_dist_data(ps: PartitionSet, cfg: GNNConfig, device) -> dict:
    """Rank-stacked ``[R, ...]`` tables on ``device``: features, labels,
    solid counts, VID_p -> VID_o maps and the push contract mask — built
    once per partitioning, never per step."""
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return {
        "features": t(_pad_stack([p.features for p in ps.parts], 0.0)),
        "labels": t(_pad_stack([p.labels.astype(np.int32)
                                for p in ps.parts], 0)),
        "num_solid": t(np.array([p.num_solid for p in ps.parts], np.int32)),
        "vid_o": t(_pad_stack([p.vid_p_to_o().astype(np.int32)
                               for p in ps.parts], -1)),
        **build_exchange_plan(ps, host_indices=False).device_tables(device),
    }


def minibatch_to_device(mb: dict, device) -> dict:
    """The host ``[R, ...]`` minibatch (``stack_ranks``) as tensors."""
    t = lambda a: torch.as_tensor(a).to(device)  # noqa: E731
    return {k: [t(a) for a in v] if isinstance(v, list) else t(v)
            for k, v in mb.items()}


def _epoch_mean(ep_metrics: List[dict]) -> dict:
    """Loss/acc weighted by real example count (padded empty batches weigh
    nothing), other per-step metrics plain-averaged, and per layer the
    epoch's HEC hit rate ``hec_hit_rate_l{l}`` = summed hits over summed
    halos (absent when no halo row was looked up)."""
    if not ep_metrics:                   # zero-step epoch: no train seeds
        return {"examples": 0.0, "loss": 0.0, "acc": 0.0}
    w = np.array([m.get("examples", 1.0) for m in ep_metrics], np.float64)
    total = w.sum()
    out = {}
    for key in ep_metrics[0]:
        vals = np.array([m[key] for m in ep_metrics], np.float64)
        if key in ("loss", "acc"):
            out[key] = float((vals * w).sum() / max(total, 1.0))
        elif key == "examples":
            out[key] = float(total)
        else:
            out[key] = float(vals.mean())
    for key in ep_metrics[0]:
        if key.startswith("hec_hits_l"):
            l = key[len("hec_hits_l"):]
            halos = sum(m[f"hec_halos_l{l}"] for m in ep_metrics)
            if halos:
                out[f"hec_hit_rate_l{l}"] = \
                    sum(m[key] for m in ep_metrics) / halos
    return out


def default_push_uniforms(device: torch.device,
                          base_seed: int = 7) -> PushUniforms:
    """The reference's selection uniforms in [1e-6, 1), bit for bit:
    ``jax.random.uniform(fold_in(fold_in(PRNGKey(base_seed), seed), rank),
    shape, minval=1e-6, maxval=1.0)`` (``repro/comm/engine.py:
    select_push``), drawn on ``device`` by the tensor Threefry of
    ``pipeline/threefry.py``."""
    def draw(seed: int, rank: int, shape: Sequence[int]) -> torch.Tensor:
        k = threefry.fold_in(threefry.fold_in(threefry.key(base_seed),
                                              int(seed) & 0xFFFFFFFF), rank)
        return threefry.uniform(k, shape, 1e-6, 1.0, device)
    return draw


@dataclasses.dataclass
class RankForward:
    """One rank's forward: the loss to differentiate and what the push
    and the metrics read."""
    loss: torch.Tensor
    nll_sum: torch.Tensor
    correct: torch.Tensor
    n_valid: torch.Tensor
    captured: List
    hits: List
    nodes0: torch.Tensor
    mask0: torch.Tensor
    vid0: torch.Tensor


@dataclasses.dataclass
class DistTrainer:
    """R-rank GNN trainer (``cfg.model``) in ``aep`` mode on one device.

    ``push_uniforms(seed, rank, (R, N0))`` gives the AEP selection's
    uniforms for a step (default: :func:`default_push_uniforms`).
    ``step_log`` keeps every training step's metrics."""
    cfg: GNNConfig
    num_ranks: int
    mode: str = "aep"
    device: DeviceLike = None
    push_uniforms: Optional[PushUniforms] = None

    def __post_init__(self):
        if self.mode != "aep":
            raise NotImplementedError(
                f"mode {self.mode!r}: only aep is ported; sync and drop "
                f"come with a later slice")
        self.device = resolve_device(self.device)
        self.comm = StackedCollective(self.num_ranks)
        h = self.cfg.hec
        self.engine = HaloExchangeEngine(self.num_ranks, self.cfg.num_layers,
                                         h.push_limit, h.delay, self.comm)
        if self.push_uniforms is None:
            self.push_uniforms = default_push_uniforms(self.device)
        self.step_log: List[dict] = []

    # -- state ---------------------------------------------------------------
    def init_state(self, seed: int = 0, params: Optional[dict] = None) -> dict:
        """Fresh state: ``cfg.model``'s model (the reference's weights
        from ``jax.random.key(seed)``, or its ``{"layers": [...]}`` tree
        ``params``), Adam, one empty HEC per (layer, rank) and empty
        in-flight queues."""
        cfg, dev = self.cfg, self.device
        model = build_model(cfg, seed=seed, device=dev, params=params)
        dims = layer_dims(cfg)
        hec = [[hec_lib.hec_init(cfg.hec.cache_size, cfg.hec.ways, dims[l],
                                 dev) for _ in range(self.num_ranks)]
               for l in range(cfg.num_layers)]
        return {"model": model, "opt": opt_lib.adam_init(
                    model.parameter_list()),
                "hec": hec,
                "inflight": self.engine.inflight_init(max(dims), dev),
                "step": 0}

    # -- one rank's forward ----------------------------------------------------
    def _rank_forward(self, model, hec, data: dict, mb: dict, r: int,
                      seed: int, dropout: float) -> RankForward:
        num_solid = data["num_solid"][r]
        feats = data["features"][r]
        vid_o = data["vid_o"][r]
        nodes = [n[r] for n in mb["layer_nodes"]]
        masks = [m[r] for m in mb["node_mask"]]
        vid_o_nodes = [torch.where(n >= 0,
                                   vid_o[n.clamp(0, vid_o.shape[0] - 1).long()],
                                   -1) for n in nodes]
        # layer-0 inputs: own features, HEC hits for halo rows
        nodes0, mask0 = nodes[0], masks[0]
        is_halo0 = (nodes0 >= num_solid) & mask0
        keep0 = mask0 & ~is_halo0
        h0 = feats[nodes0.clamp(0, feats.shape[0] - 1).long()] \
            * keep0[:, None].float()
        hit0, emb0 = hec_lib.hec_lookup(hec[0][r], vid_o_nodes[0])
        use0 = is_halo0 & hit0
        h0 = torch.where(use0[:, None], emb0, h0)
        valid0 = keep0 | use0
        hits = [(use0.sum(), is_halo0.sum())]
        captured = {}

        def halo_hook(k, h, valid):
            if k == 0:
                captured[0] = (h, valid)
                return h, valid
            is_halo = (nodes[k] >= num_solid) & masks[k]
            hit, emb = hec_lib.hec_lookup(hec[k][r], vid_o_nodes[k])
            use = is_halo & hit
            h = torch.where(use[:, None], emb[:, :h.shape[1]], h)
            valid = (valid & ~is_halo) | use
            hits.append((use.sum(), is_halo.sum()))
            captured[k] = (h.detach(), valid)
            return h, valid

        out, valid = model.train_forward(
            h0, valid0, {"nbr_idx": [x[r] for x in mb["nbr_idx"]]},
            dropout=dropout, seed=seed, halo_hook=halo_hook)
        B = mb["seeds"].shape[1]
        logits = out[:B]
        lmask = mb["seed_mask"][r] & valid[:B]
        labels = mb["labels"][r].long()
        logz = torch.logsumexp(logits, -1)
        gold = logits.gather(1, labels[:, None])[:, 0]
        nll = (logz - gold) * lmask.float()
        n_valid = lmask.sum()
        nll_sum = nll.sum()
        correct = ((logits.argmax(-1) == labels) & lmask).sum()
        return RankForward(
            loss=nll_sum / n_valid.clamp_min(1), nll_sum=nll_sum.detach(),
            correct=correct, n_valid=n_valid,
            captured=[captured[l] for l in range(self.cfg.num_layers)],
            hits=hits, nodes0=nodes0, mask0=mask0, vid0=vid_o_nodes[0])

    def _consume(self, hec, inflight):
        dims = layer_dims(self.cfg)
        for r in range(self.num_ranks):
            self.engine.consume_push([layer[r] for layer in hec],
                                     inflight[r], dims,
                                     self.cfg.hec.life_span)

    # -- the step ---------------------------------------------------------------
    def train_step(self, state: dict, data: dict, mb: dict,
                   seed: int) -> dict:
        """One synchronized step of every rank on the device minibatch
        ``mb`` with the u32 ``seed``; updates ``state`` in place and
        returns the step's metrics (floats)."""
        cfg, R, L = self.cfg, self.num_ranks, self.cfg.num_layers
        dims = layer_dims(cfg)
        model, hec = state["model"], state["hec"]
        self._consume(hec, state["inflight"])
        fwd = [self._rank_forward(model, hec, data, mb, r, seed,
                                  cfg.dropout) for r in range(R)]
        # the push reads only forward activations: dispatched before the
        # backward, as the paper overlaps it with backward compute
        selections = []
        for r, f in enumerate(fwd):
            u = self.push_uniforms(seed, r, (R, f.nodes0.shape[0]))
            selections.append(self.engine.select_push(
                data["push_mask"][r], f.nodes0, f.mask0, f.vid0,
                data["num_solid"][r], f.captured, u, dims, max(dims)))
        state["inflight"], push = self.engine.aep_push(
            selections, state["inflight"], dims)
        params = model.parameter_list()
        rank_grads = [torch.autograd.grad(f.loss, params) for f in fwd]
        # example-weighted all-reduce: the gradient of the global batch mean
        n_valid = torch.stack([f.n_valid for f in fwd])
        examples = self.comm.psum(n_valid)
        weight = n_valid.float()
        denom_f = examples.float().clamp_min(1.0)
        grads = [self.comm.psum(torch.stack(
                     [g[i] * weight[r] for r, g in enumerate(rank_grads)]))
                 / denom_f for i in range(len(params))]
        denom = examples.clamp_min(1)
        loss_m = self.comm.psum(torch.stack([f.nll_sum for f in fwd])) / denom
        acc_m = self.comm.psum(torch.stack([f.correct for f in fwd])) / denom
        diag = opt_lib.adam_update(
            grads, state["opt"], params,
            opt_lib.AdamConfig(lr=cfg.lr, grad_clip=1.0))
        state["step"] += 1
        metrics = {"loss": loss_m, "acc": acc_m, "examples": examples,
                   "grad_norm": diag["grad_norm"],
                   "aep_push_rows": self.comm.psum(push["push_rows"]),
                   "aep_push_bytes": self.comm.psum(push["push_bytes"])}
        for l in range(L):
            metrics[f"hec_hits_l{l}"] = self.comm.psum(
                torch.stack([f.hits[l][0] for f in fwd]))
            metrics[f"hec_halos_l{l}"] = self.comm.psum(
                torch.stack([f.hits[l][1] for f in fwd]))
        for l in range(L):
            metrics[f"hec_occ_l{l}"] = float(np.mean(
                [hec_lib.hec_occupancy(st) for st in hec[l]]))
        return {k: float(v) for k, v in metrics.items()}

    # -- epochs ------------------------------------------------------------------
    def train_epochs(self, ps: PartitionSet, data: dict, state: dict,
                     num_epochs: int, seed0: int = 0, log_every: int = 0):
        """Train ``num_epochs`` epochs on the reference's minibatch stream
        (``SamplingPlan`` with ``base_seed=seed0``, prefetched by the
        config's workers).  Returns ``(state, history)``: per epoch the
        metrics' means and the host seconds of the ``sample``,
        ``host_prep``, ``stage`` and ``step`` spans (``t_<span>``) and of
        the epoch (``t_wall``), and the fanout draw's ``sampler_policy``."""
        cfg = self.cfg
        plan = SamplingPlan(ps, cfg, base_seed=seed0, device=self.device)
        reg = obs.get().registry
        phases = ("sample", "host_prep", "stage", "step")
        s_policy = cfg.pipeline.sampler.policy
        history = []
        for ep in range(num_epochs):
            if s_policy == "cv" and cfg.pipeline.sampler.device_draw:
                # control-variate sampling: the draw's weights prefer
                # vertices with a live line in the HEC as it is now
                plan.set_cv_residency(self._cv_residency(ps, state))
            ep_metrics = []
            ph0 = {p: reg.value("phase_seconds", phase=p) for p in phases}
            wall0 = time.perf_counter()
            for host in plan.batches(plan.epoch_schedule(ep), ep):
                with obs.span("stage"):
                    mb = minibatch_to_device(host, self.device)
                with obs.span("step"):
                    m = self.train_step(state, data, mb, state["step"])
                ep_metrics.append(m)
                self.step_log.append(m)
            mean = _epoch_mean(ep_metrics)
            mean["sampler_policy"] = s_policy
            for p in phases:
                mean[f"t_{p}"] = reg.value("phase_seconds", phase=p) - ph0[p]
            mean["t_wall"] = time.perf_counter() - wall0
            history.append(mean)
            if log_every and (ep % log_every == 0 or ep == num_epochs - 1):
                hl = " ".join(
                    f"l{l}:{mean.get(f'hec_hits_l{l}', 0) / max(mean.get(f'hec_halos_l{l}', 1), 1):.2f}"  # noqa: E501
                    for l in range(cfg.num_layers))
                print(f"[{self.mode}] epoch {ep}: loss={mean['loss']:.4f} "
                      f"acc={mean['acc']:.3f} hit-rates {hl}")
        return state, history

    def _cv_residency(self, ps: PartitionSet, state: dict) -> List[np.ndarray]:
        """Per rank a bool mask over VID_p: the vertices with a live line
        in any layer's HEC of that rank (tags hold VID_o); the reference's
        ``_cv_residency``, one host read of the tags per epoch."""
        V = sum(p.num_solid for p in ps.parts)
        masks = []
        for r, p in enumerate(ps.parts):
            res_o = np.zeros(V, bool)
            for layer in state["hec"]:
                tags = layer[r].tags.cpu().numpy()
                t = tags[tags >= 0]
                res_o[t[t < V]] = True
            masks.append(res_o[np.clip(p.vid_p_to_o(), 0, V - 1)])
        return masks

    @torch.no_grad()
    def evaluate(self, ps: PartitionSet, data: dict, state: dict,
                 num_batches: int = 8, seed0: int = 123) -> float:
        """Test accuracy over sampled test-vertex minibatches (the
        reference's eval stream), dropout off.  Each batch starts from the
        training state as it is — one tick + consume of the in-flight
        queue on copies of the HECs — and the training state is never
        written."""
        plan = SamplingPlan(ps, self.cfg, base_seed=seed0,
                            device=self.device)
        schedule = plan.eval_schedule(num_batches, seed0)
        accs, weights = [], []
        for k, host in enumerate(plan.batches(schedule,
                                              EVAL_EPOCH_TAG + seed0)):
            mb = minibatch_to_device(host, self.device)
            hec = [[hec_lib.hec_clone(st) for st in layer]
                   for layer in state["hec"]]
            self._consume(hec, state["inflight"])
            fwd = [self._rank_forward(state["model"], hec, data, mb, r,
                                      10_000 + k, 0.0)
                   for r in range(self.num_ranks)]
            examples = int(sum(int(f.n_valid) for f in fwd))
            correct = int(sum(int(f.correct) for f in fwd))
            accs.append(correct / max(examples, 1))
            weights.append(float(examples))
            del hec
        if not sum(weights):
            return 0.0
        return float(np.average(accs, weights=weights))
