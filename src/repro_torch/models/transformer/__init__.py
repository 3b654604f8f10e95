"""The LM stack (port of ``repro/models/transformer``): the ten assigned
architectures' blocks and model, in plain PyTorch (no kernel of the
reference's LM path is a Pallas kernel)."""
from repro_torch.models.transformer import model  # noqa: F401
from repro_torch.models.transformer.model import (  # noqa: F401
    TransformerLM, decode_step, forward, init_cache, init_params,
    logits_from_hidden)
