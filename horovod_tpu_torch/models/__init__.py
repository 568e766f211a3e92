"""Models of the PyTorch port."""

from horovod_tpu_torch.models.moe import (  # noqa: F401
    MoEBlock,
    MoEConfig,
    MoETransformerLM,
    SwitchFFN,
    moe_aux_loss,
)
from horovod_tpu_torch.models.transformer import (  # noqa: F401
    TransformerConfig,
    TransformerLM,
    lm_loss,
)

__all__ = ["MoEBlock", "MoEConfig", "MoETransformerLM", "SwitchFFN",
           "moe_aux_loss", "TransformerConfig", "TransformerLM", "lm_loss"]
