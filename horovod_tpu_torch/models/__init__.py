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
from horovod_tpu_torch.models.vit import (  # noqa: F401
    ViT_B16,
    ViT_S16,
    ViTConfig,
    VisionTransformer,
    vit_loss,
)

__all__ = ["MoEBlock", "MoEConfig", "MoETransformerLM", "SwitchFFN",
           "moe_aux_loss", "TransformerConfig", "TransformerLM", "lm_loss",
           "ViTConfig", "VisionTransformer", "ViT_S16", "ViT_B16",
           "vit_loss"]
