"""Model FLOPs of a request, counted from the configuration and the
request's shapes alone, so that the count is the same whatever computes
the work.

Counted: every conv (2 * out pixels * Co * Ci * k * k), linear
(2 * rows * in * out) and attention product (Q K^T and P V, 2 * Sq * Skv
* width each) of the VAE encoder, the UNet at one timestep and the
skip-fused decoder; for a train step also the text tower, LPIPS' VGG16,
the CLIP-sim and discriminator ViTs and the heads, over the four passes.
Backward: the input gradient is 1x the forward of every layer it crosses;
a weight gradient is 1x the forward of a layer whose whole weight trains
(the UNet's conv_in, a skip conv, a head), and of a LoRA-adapted layer
only its factors' 2 * rows * r * (in * k * k + out), since the base weight
is frozen. Not counted: biases,
norms, activations, softmax, resampling, canny and remat's recompute. An
upsample's conv is counted at its output size, as the model defines it.
"""

from __future__ import annotations

from port_bench.reference.aux_models import VGG_PLAN
from port_bench.reference.sd_turbo import _unet_levels, skip_conv_channels

TOKENS = 77


class Count:
    """Forward FLOPs (`total`), the weight gradients' FLOPs (`wgrad`) and
    the LoRA factors' parameters (`lora_params`) of the layers counted.
    `rank` is the LoRA rank of the model being counted (0: none)."""

    def __init__(self, rank: int = 0):
        self.total = 0
        self.wgrad = 0
        self.lora_params = 0
        self.rank = rank

    def _add(self, rows, fan_in, out, n, whole, lora):
        fwd = 2 * rows * fan_in * out * n
        self.total += fwd
        if whole:
            self.wgrad += fwd
        if lora and self.rank:
            self.wgrad += 2 * rows * self.rank * (fan_in + out) * n
            self.lora_params += self.rank * (fan_in + out) * n

    def conv(self, h, w, ci, co, k=3, whole=False, lora=True):
        self._add(h * w, ci * k * k, co, 1, whole, lora)

    def linear(self, rows, ci, co, n=1, whole=False, lora=True):
        """`n` layers of ci -> co on `rows` rows."""
        self._add(rows, ci, co, n, whole, lora)

    def attn(self, sq, skv, width):
        self.total += 4 * sq * skv * width

    def resnet(self, h, w, ci, co, temb=None):
        self.conv(h, w, ci, co)
        if temb:
            self.linear(1, temb, co, lora=False)
        self.conv(h, w, co, co)
        if ci != co:
            self.conv(h, w, ci, co, k=1)

    def transformer(self, s, c, cross):
        self.linear(s, c, c)                      # proj_in
        self.linear(s, c, c, n=3)                 # attn1 q, k, v
        self.attn(s, s, c)
        self.linear(s, c, c)                      # attn1 out
        self.linear(s, c, c)                      # attn2 q
        self.linear(TOKENS, cross, c, n=2)        # attn2 k, v
        self.attn(s, TOKENS, c)
        self.linear(s, c, c)                      # attn2 out
        self.linear(s, c, 8 * c)                  # GEGLU projection
        self.linear(s, 4 * c, c)
        self.linear(s, c, c)                      # proj_out


def _down(n: int, pad_lo: int) -> int:
    return (n + pad_lo + 1 - 3) // 2 + 1


def unet(cnt: Count, cfg, h: int, w: int):
    chans, _, has_attn = _unet_levels(cfg)
    n, layers = len(chans), cfg["layers_per_block"]
    temb, cross = 4 * chans[0], cfg["cross_attention_dim"]
    cnt.linear(1, chans[0], temb, lora=False)
    cnt.linear(1, temb, temb, lora=False)
    cnt.conv(h, w, cfg["in_channels"], chans[0], whole=True, lora=False)
    skips = [(chans[0], h, w)]
    ci = chans[0]
    for i, co in enumerate(chans):
        for j in range(layers):
            cnt.resnet(h, w, ci if j == 0 else co, co, temb)
            if has_attn[i]:
                cnt.transformer(h * w, co, cross)
            skips.append((co, h, w))
        if i < n - 1:
            h, w = _down(h, 1), _down(w, 1)
            cnt.conv(h, w, co, co)
            skips.append((co, h, w))
        ci = co
    c = chans[-1]
    cnt.resnet(h, w, c, c, temb)
    cnt.transformer(h * w, c, cross)
    cnt.resnet(h, w, c, c, temb)
    prev = c
    for i in range(n):
        lvl = n - 1 - i
        co = chans[lvl]
        for j in range(layers + 1):
            sc, _, _ = skips.pop()
            cnt.resnet(h, w, prev + sc, co, temb)
            prev = co
            if has_attn[lvl]:
                cnt.transformer(h * w, co, cross)
        if i < n - 1:
            _, h, w = skips[-1]
            cnt.conv(h, w, co, co)
    cnt.conv(h, w, chans[0], cfg["out_channels"])


def _vae_mid(cnt: Count, h, w, c):
    cnt.resnet(h, w, c, c)
    cnt.linear(h * w, c, c, n=4)                  # q, k, v, out
    cnt.attn(h * w, h * w, c)
    cnt.resnet(h, w, c, c)


def vae_encode(cnt: Count, cfg, h: int, w: int):
    chans, n = cfg["block_out_channels"], len(cfg["block_out_channels"])
    lat = cfg["latent_channels"]
    cnt.conv(h, w, cfg["in_channels"], chans[0])
    ci = chans[0]
    for i, co in enumerate(chans):
        for j in range(cfg["layers_per_block"]):
            cnt.resnet(h, w, ci if j == 0 else co, co)
        if i < n - 1:
            h, w = _down(h, 0), _down(w, 0)
            cnt.conv(h, w, co, co)
        ci = co
    _vae_mid(cnt, h, w, chans[-1])
    cnt.conv(h, w, chans[-1], 2 * lat)
    cnt.conv(h, w, 2 * lat, 2 * lat, k=1, lora=False)
    return h, w


def vae_decode(cnt: Count, cfg, h: int, w: int):
    rev = list(reversed(cfg["block_out_channels"]))
    n, lat = len(rev), cfg["latent_channels"]
    cnt.conv(h, w, lat, lat, k=1, lora=False)
    cnt.conv(h, w, lat, rev[0])
    _vae_mid(cnt, h, w, rev[0])
    skips = skip_conv_channels(cfg)
    ci = rev[0]
    for i, co in enumerate(rev):
        cnt.conv(h, w, skips[i][0], skips[i][1], k=1, whole=True)
        for j in range(cfg["layers_per_block"] + 1):
            cnt.resnet(h, w, ci if j == 0 else co, co)
        if i < n - 1:
            h, w = 2 * h, 2 * w
            cnt.conv(h, w, co, co)
        ci = co
    cnt.conv(h, w, rev[-1], cfg["out_channels"])


def lora_ranks(cfg) -> dict:
    """{model: LoRA rank} of the configuration's adapters."""
    return {ad["model"]: ad["rank"] for ad in cfg.get("adapters", [])}


def generator(cfg, height: int, width: int) -> Count:
    ranks = lora_ranks(cfg)
    cnt = Count(ranks.get("vae", 0))
    h, w = vae_encode(cnt, cfg["vae"], height, width)
    cnt.rank = ranks.get("unet", 0)
    unet(cnt, cfg["unet"], h, w)
    cnt.rank = ranks.get("vae", 0)
    vae_decode(cnt, cfg["vae"], h, w)
    return cnt


def serve_image(cfg, height: int, width: int) -> int:
    """Model FLOPs of one image of a served request."""
    return generator(cfg, height, width).total


def encoder_layers(cnt: Count, tokens, d, inter, layers):
    for _ in range(layers):
        cnt.linear(tokens, d, d, n=4)                  # q, k, v, out
        cnt.attn(tokens, tokens, d)
        cnt.linear(tokens, d, inter)
        cnt.linear(tokens, inter, d)


def text_tower(cfg) -> int:
    cnt = Count()
    encoder_layers(cnt, TOKENS, cfg["hidden_size"], cfg["intermediate_size"],
                   cfg["num_hidden_layers"])
    return cnt.total


def clip_vision(cfg) -> int:
    v = cfg["vision_config"]
    g = v["image_size"] // v["patch_size"]
    cnt = Count()
    cnt.conv(g, g, 3, v["hidden_size"], k=v["patch_size"])
    encoder_layers(cnt, g * g + 1, v["hidden_size"], v["intermediate_size"],
                   v["num_hidden_layers"])
    cnt.linear(1, v["hidden_size"], cfg["projection_dim"])
    return cnt.total


def disc_heads(cfg) -> int:
    v = cfg["vision_config"]
    g = v["image_size"] // v["patch_size"]
    go = (g + 2 - 3) // 2 + 1
    cnt = Count()
    for _ in range(2):
        cnt.conv(go, go, v["hidden_size"], 256)
        cnt.conv(go, go, 256, 1, k=1)
    cnt.linear(1, cfg["projection_dim"], 256)
    cnt.linear(1, 256, 1)
    return cnt.total


def _vgg_sizes(height, width):
    h, w = height, width
    for i, (co, n) in enumerate(VGG_PLAN):
        if i:
            h, w = h // 2, w // 2
        yield h, w, co, n


def vgg16(height: int, width: int) -> int:
    """VGG16's 13 convs on one image."""
    cnt, ci = Count(), 3
    for h, w, co, n in _vgg_sizes(height, width):
        for _ in range(n):
            cnt.conv(h, w, ci, co)
            ci = co
    return cnt.total


def lpips_heads(height: int, width: int) -> int:
    """The five 1x1 LPIPS heads on one pair's feature differences."""
    cnt = Count()
    for h, w, co, _ in _vgg_sizes(height, width):
        cnt.conv(h, w, co, 1, k=1)
    return cnt.total


def lpips(height: int, width: int) -> int:
    """LPIPS of one pair: VGG16 on both images and the heads."""
    return 2 * vgg16(height, width) + lpips_heads(height, width)


def paired_step(cfg, batch: int, height: int, width: int) -> int:
    """Model FLOPs of one paired step of `batch` images: the text tower;
    pass 1 the generator forward and backward, LPIPS on the output and the
    target with its input gradient, CLIP-sim's vision tower forward and
    input gradient and its text tower; pass 2 the generator forward and
    backward and the discriminator's backbone and heads forward and input
    gradient; passes 3 and 4 the backbone forward and the heads forward and
    weight gradient."""
    g = generator(cfg, height, width)
    gen = g.total * 2 + g.wgrad
    clip, heads = cfg["clip"], disc_heads(cfg["clip"])
    vis = clip_vision(clip) + heads
    per_image = (text_tower(cfg["text_encoder"])
                 + gen + lpips(height, width) + vgg16(height, width)
                 + lpips_heads(height, width) + 2 * clip_vision(clip)
                 + text_tower(clip["text_config"])
                 + gen + 2 * vis
                 + 2 * (vis + heads))
    return per_image * batch
