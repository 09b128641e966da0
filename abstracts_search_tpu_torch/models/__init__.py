"""Query encoders: the stella encoder (a Qwen2 backbone, masked pooling
and the MRL head; ``qwen2.py``, ``stella.py``; or Moonlight-16B-A3B's
sparse-expert backbone under the same head, ``moonlight.py``, or
Kimi-Linear-48B-A3B's hybrid linear-attention one, ``kimi_linear.py``), its
embedding pipeline (``embed.py``), weight carrying from the JAX package and HF snapshots
(``convert.py``), the safetensors checkpoint (``checkpoint.py``), and the
registry that picks stella or the offline ``HashEmbedder`` by name
(``registry.py``)."""

from .kimi_linear import KimiLinearConfig, KimiLinearEncoder
from .moonlight import MoonlightConfig, MoonlightEncoder
from .qwen2 import Qwen2Config, Qwen2Encoder
from .registry import HashEmbedder, StellaEmbedder, get_embedder
from .stella import PROMPTS, StellaConfig, StellaEncoder

__all__ = ["HashEmbedder", "KimiLinearConfig", "KimiLinearEncoder", "MoonlightConfig",
           "MoonlightEncoder", "PROMPTS", "Qwen2Config", "Qwen2Encoder", "StellaConfig",
           "StellaEmbedder", "StellaEncoder", "get_embedder"]
