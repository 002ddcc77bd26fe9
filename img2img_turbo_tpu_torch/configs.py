"""Model configurations: a copy of the dataclasses and presets of
`img2img_turbo_tpu/configs.py`, so that the port imports nothing of the JAX
package (`tests/test_torch_ops.py` holds each preset equal to its JAX
counterpart, field by field).

SD-Turbo presets mirror the HuggingFace `stabilityai/sd-turbo` configs; the
tiny and micro presets keep the topology at small widths, for tests.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """UNet2DConditionModel-equivalent config (SD 2.1 / SD-Turbo family)."""

    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    # attention head count per level = channels // head_dim
    attention_head_dim: Tuple[int, ...] = (5, 10, 20, 20)
    cross_attention_dim: int = 1024
    # which down/up levels carry transformer blocks (SD: all but the deepest)
    transformer_levels: Tuple[bool, ...] = (True, True, True, False)
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    # Transformer2D input GroupNorm eps (diffusers uses 1e-6 here)
    attn_norm_eps: float = 1e-6
    time_embed_dim_mult: int = 4  # time MLP dim = block_out_channels[0] * 4
    freq_shift: float = 0.0
    flip_sin_to_cos: bool = True

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * self.time_embed_dim_mult

    @property
    def num_levels(self) -> int:
        return len(self.block_out_channels)


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """AutoencoderKL-equivalent config (SD VAE), with first-class skip taps."""

    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    norm_eps: float = 1e-6
    scaling_factor: float = 0.18215
    # skip-fusion zero-conv output channels, decoder order (reference
    # pix2pix_turbo.py:40-43: 512->512, 256->512, 128->512, 128->256)
    # in/out channels are derived from block_out_channels below.

    @property
    def num_levels(self) -> int:
        return len(self.block_out_channels)

    @property
    def skip_conv_channels(self) -> Tuple[Tuple[int, int], ...]:
        """(in_ch, out_ch) of the 4 skip zero-convs, decoder up-block order.

        Skip i feeds the input of decoder up-block i; the tapped encoder
        activation is the *input* of encoder down-block (n-1-i), and the
        decoder sample at that point has the channel count of the previous
        (deeper) decoder level.
        """
        chans = self.block_out_channels
        n = len(chans)
        rev = list(reversed(chans))  # decoder level output channels
        out = []
        for i in range(n):
            in_ch = chans[max(n - 1 - i - 1, 0)]  # encoder block input channels
            out_ch = rev[max(i - 1, 0)]  # decoder sample channels before block i
            out.append((in_ch, out_ch))
        return tuple(out)


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    """CLIPTextModel-equivalent config (OpenCLIP ViT-H text tower, trimmed to
    23 layers as in SD 2.x / SD-Turbo)."""

    vocab_size: int = 49408
    hidden_size: int = 1024
    num_layers: int = 23
    num_heads: int = 16
    intermediate_size: int = 4096
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5
    hidden_act: str = "gelu"  # SD2.x text encoder uses exact gelu


# ---------------------------------------------------------------------------
# Presets
# ---------------------------------------------------------------------------

SD_TURBO_UNET = UNetConfig()
SD_TURBO_VAE = VAEConfig()
SD_TURBO_TEXT = CLIPTextConfig()

# Tiny configs for tests: same topology, tiny widths.
TINY_UNET = UNetConfig(
    block_out_channels=(32, 64, 64, 64),
    attention_head_dim=(2, 4, 4, 4),
    cross_attention_dim=32,
    norm_num_groups=8,
)
TINY_VAE = VAEConfig(
    block_out_channels=(16, 32, 32, 32),
    norm_num_groups=8,
)
TINY_TEXT = CLIPTextConfig(
    vocab_size=1000,
    hidden_size=32,
    num_layers=2,
    num_heads=4,
    intermediate_size=64,
    max_position_embeddings=77,
)

# Micro configs: 2 levels, 1 layer per block — for training-step tests and
# multichip dryruns where XLA-CPU compile time of the fused multi-pass GAN
# step dominates. Same code paths, ~6x smaller graphs.
MICRO_UNET = UNetConfig(
    block_out_channels=(32, 64),
    layers_per_block=1,
    attention_head_dim=(2, 4),
    cross_attention_dim=32,
    transformer_levels=(True, False),
    norm_num_groups=8,
)
MICRO_VAE = VAEConfig(
    block_out_channels=(16, 32),
    layers_per_block=1,
    norm_num_groups=8,
)
