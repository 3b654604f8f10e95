"""The port's GNN models, ``graphsage`` and ``gat``, chosen by
``cfg.model`` through :func:`build_model`.  The submodules are imported
inside it: the kernels' plain versions import ``common`` from this
package, and the models import the kernels."""
from __future__ import annotations

from typing import Optional

from repro_torch.device import DeviceLike

__all__ = ["build_model", "gat", "graphsage", "init", "model_class"]


def model_class(name: str):
    """The model class of ``cfg.model`` == ``name``."""
    from repro_torch.models.gnn.gat import GAT
    from repro_torch.models.gnn.graphsage import GraphSAGE
    models = {"graphsage": GraphSAGE, "gat": GAT}
    if name not in models:
        raise ValueError(f"unknown model {name!r}; expected one of "
                         f"{sorted(models)}")
    return models[name]


def build_model(cfg, seed: int = 0, device: DeviceLike = None,
                params: Optional[dict] = None, init: str = "reference"):
    """``cfg.model``'s model at ``cfg``'s widths, with the reference's tree
    ``params`` or else weights drawn from ``seed`` (``init="reference"``:
    the reference's ``jax.random.key(seed)`` weights; ``"numpy"``: a numpy
    seed's), on ``device`` (``None``: the card; raises without one)."""
    return model_class(cfg.model).from_config(cfg, seed=seed, device=device,
                                              params=params, init=init)
