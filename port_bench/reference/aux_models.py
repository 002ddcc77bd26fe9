"""Plain fp32 PyTorch reference of the paired step's auxiliary models, on
{published name: tensor} dicts (see PROVENANCE.md):
- the OpenCLIP-H text tower as transformers' CLIPTextModel (`text_model.*`,
  exact GELU, causal mask, final layer norm);
- OpenAI CLIP ViT-B/32 as transformers' CLIPModel (`vision_model.*`,
  `text_model.*`, projections, QuickGELU), for CLIP-sim and as the
  vision-aided discriminator's frozen backbone;
- VGG16 features (torchvision's `features.<i>`) with the LPIPS heads
  (`lin<i>.model.1.weight`);
- the discriminator's three spectral-normalised heads and the multilevel
  sigmoid GAN losses.
`q` rounds both operands of every conv and linear (the control).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from port_bench.reference.sd_turbo import ident

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
LPIPS_SHIFT = (-0.030, -0.088, -0.188)
LPIPS_SCALE = (0.458, 0.448, 0.450)
VGG_FEATURES = ((0, 2), (5, 7), (10, 12, 14), (17, 19, 21), (24, 26, 28))
SN_EPS = 1e-12


def _lin(p, name, x, q):
    return F.linear(q(x), q(p[name + ".weight"]), p.get(name + ".bias"))


def _ln(p, name, x, eps):
    return F.layer_norm(x, x.shape[-1:], p[name + ".weight"],
                        p[name + ".bias"], eps)


def _act(name):
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    return F.gelu


def text_tower(p, cfg, ids, q=ident):
    """CLIPTextModel's last hidden state (B, S, hidden); p under
    `text_model.`."""
    s = ids.shape[1]
    x = p["text_model.embeddings.token_embedding.weight"][ids] \
        + p["text_model.embeddings.position_embedding.weight"][None, :s]
    mask = torch.full((s, s), float("-inf"), device=x.device).triu(1)
    act, eps = _act(cfg["hidden_act"]), cfg["layer_norm_eps"]
    for i in range(cfg["num_hidden_layers"]):
        x = _block(p, f"text_model.encoder.layers.{i}", x,
                   cfg["num_attention_heads"], act, eps, q, mask)
    return _ln(p, "text_model.final_layer_norm", x, eps)


def clip_vision(p, cfg, pixels, q=ident):
    """pixels (B, 3, S, S) normalised -> (projected embedding, per-block
    token features)."""
    v = cfg["vision_config"]
    x = F.conv2d(q(pixels), q(p["vision_model.embeddings.patch_embedding"
                                 ".weight"]), stride=v["patch_size"])
    b, d = x.shape[:2]
    x = x.flatten(2).transpose(1, 2)
    cls = p["vision_model.embeddings.class_embedding"].expand(b, 1, d)
    x = torch.cat([cls, x], 1) \
        + p["vision_model.embeddings.position_embedding.weight"][None]
    eps = v["layer_norm_eps"]
    x = _ln(p, "vision_model.pre_layrnorm", x, eps)
    blocks = []
    act = _act(v["hidden_act"])
    for i in range(v["num_hidden_layers"]):
        x = _block(p, f"vision_model.encoder.layers.{i}", x,
                   v["num_attention_heads"], act, eps, q)
        blocks.append(x)
    pooled = _ln(p, "vision_model.post_layernorm", x[:, 0], eps)
    return _lin(p, "visual_projection", pooled, q), blocks


def _block(p, lp, x, heads, act, eps, q, mask=None):
    b, s, d = x.shape
    hd = d // heads
    h = _ln(p, lp + ".layer_norm1", x, eps)
    qh, kh, vh = (_lin(p, f"{lp}.self_attn.{n}_proj", h, q)
                  .reshape(b, s, heads, hd).transpose(1, 2)
                  for n in ("q", "k", "v"))
    sc = q(qh) @ q(kh).transpose(-1, -2) / math.sqrt(hd)
    if mask is not None:
        sc = sc + mask
    o = (q(torch.softmax(sc, -1)) @ q(vh)).transpose(1, 2).reshape(b, s, d)
    x = x + _lin(p, lp + ".self_attn.out_proj", o, q)
    h = _ln(p, lp + ".layer_norm2", x, eps)
    return x + _lin(p, lp + ".mlp.fc2", act(_lin(p, lp + ".mlp.fc1", h, q)),
                    q)


def clip_text(p, cfg, ids, q=ident):
    """CLIPModel's projected text embedding, pooled at the highest id."""
    x = text_tower(p, cfg["text_config"], ids, q)
    pooled = x[torch.arange(x.shape[0], device=x.device), ids.argmax(-1)]
    return _lin(p, "text_projection", pooled, q)


def clipsim_loss(p, cfg, pred, ids, q=ident):
    """mean(1 - cos(image, text)): pred (B, 3, H, W) in [-1, 1], resized
    bilinearly to the tower's size, ImageNet-normalised."""
    size = cfg["vision_config"]["image_size"]
    x = F.interpolate(pred, size=(size, size), mode="bilinear",
                      align_corners=False)
    mean = torch.tensor(IMAGENET_MEAN, device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(IMAGENET_STD, device=x.device).view(1, 3, 1, 1)
    iemb, _ = clip_vision(p, cfg, (x * 0.5 + 0.5 - mean) / std, q)
    temb = clip_text(p, cfg, ids, q)
    iemb = iemb / iemb.norm(dim=-1, keepdim=True)
    temb = temb / temb.norm(dim=-1, keepdim=True)
    return (1.0 - (iemb * temb).sum(-1)).mean()


def lpips(p, x, y, q=ident):
    """LPIPS-VGG distance (B,) of (B, 3, H, W) images in [-1, 1]."""
    shift = torch.tensor(LPIPS_SHIFT, device=x.device).view(1, 3, 1, 1)
    scale = torch.tensor(LPIPS_SCALE, device=x.device).view(1, 3, 1, 1)

    def feats(t):
        h, out = (t - shift) / scale, []
        for i, idxs in enumerate(VGG_FEATURES):
            if i:
                h = F.max_pool2d(h, 2)
            for j in idxs:
                h = torch.relu(F.conv2d(q(h), q(p[f"features.{j}.weight"]),
                                        p[f"features.{j}.bias"], padding=1))
            out.append(h)
        return out

    total = 0.0
    for i, (f1, f2) in enumerate(zip(feats(x), feats(y))):
        f1 = f1 / (f1.square().sum(1, keepdim=True).sqrt() + 1e-10)
        f2 = f2 / (f2.square().sum(1, keepdim=True).sqrt() + 1e-10)
        d = F.conv2d(q((f1 - f2).square()), q(p[f"lin{i}.model.1.weight"]))
        total = total + d.mean(dim=(1, 2, 3))
    return total


# ---------------------------------------------------------------------------
# Discriminator heads
# ---------------------------------------------------------------------------


def sn_weight(w, u):
    """w / sigma, sigma = u^T W v with v = normalize(W^T u) from the stored
    u (held constant)."""
    mat = w.reshape(w.shape[0], -1)
    v = (mat.t() @ u).detach()
    v = v / (v.norm() + SN_EPS)
    return w / (u @ mat @ v)


@torch.no_grad()
def sn_step(heads, sn):
    out = {}
    for k, u in sn.items():
        mat = heads[k + ".weight"].reshape(heads[k + ".weight"].shape[0], -1)
        v = mat.t() @ u
        v = v / (v.norm() + SN_EPS)
        un = mat @ v
        out[k] = un / (un.norm() + SN_EPS)
    return out


def disc_logits(p_clip, cfg, heads, sn, images, q=ident):
    """images (B, 3, H, W) in [-1, 1] -> [(B, 1, g, g), (B, 1, g, g),
    (B, 1)] from the backbone's taps after blocks n/3 and 2n/3 and its
    projected embedding."""
    v = cfg["vision_config"]
    size = v["image_size"]
    x = images * 0.5 + 0.5
    if x.shape[-1] != size or x.shape[-2] != size:
        x = F.interpolate(x, size=(size, size), mode="bicubic",
                          align_corners=False)
    mean = torch.tensor(CLIP_MEAN, device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(CLIP_STD, device=x.device).view(1, 3, 1, 1)
    emb, blocks = clip_vision(p_clip, cfg, (x - mean) / std, q)
    n = v["num_hidden_layers"]
    g = size // v["patch_size"]
    outs = []
    for i, lvl in enumerate((n // 3, 2 * n // 3 if n > 2 else n - 1)):
        t = blocks[lvl][:, 1:]
        feat = t.transpose(1, 2).reshape(t.shape[0], t.shape[2], g, g)
        name = f"spatial.{i}"
        h = F.conv2d(q(feat), q(sn_weight(heads[name + ".conv1.weight"],
                                          sn[name + ".conv1"])),
                     heads[name + ".conv1.bias"], stride=2, padding=1)
        h = F.leaky_relu(h, 0.2)
        outs.append(F.conv2d(q(h), q(sn_weight(heads[name + ".conv2.weight"],
                                               sn[name + ".conv2"])),
                             heads[name + ".conv2.bias"]))
    h = F.leaky_relu(F.linear(q(emb), q(sn_weight(
        heads["final.lin1.weight"], sn["final.lin1"])),
        heads["final.lin1.bias"]), 0.2)
    outs.append(F.linear(q(h), q(sn_weight(heads["final.lin2.weight"],
                                          sn["final.lin2"])),
                         heads["final.lin2.bias"]))
    return outs


def gan_loss(p_clip, cfg, heads, sn, images, kind, q=ident):
    """The multilevel sigmoid loss, a sum of per-level means: "gen"
    softplus(-x); "real" with one-sided smoothing 0.9 softplus(-x) +
    0.1 softplus(x); "fake" softplus(x)."""
    total = 0.0
    for lg in disc_logits(p_clip, cfg, heads, sn, images, q):
        if kind == "gen":
            loss = F.softplus(-lg)
        elif kind == "real":
            loss = 0.9 * F.softplus(-lg) + 0.1 * F.softplus(lg)
        else:
            loss = F.softplus(lg)
        total = total + loss.mean()
    return total


# ---------------------------------------------------------------------------
# Parameter shapes, in the published layouts
# ---------------------------------------------------------------------------

VGG_PLAN = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
HEAD_CHANNELS = 256


def _norm(out, name, d):
    out += [(name + ".weight", (d,)), (name + ".bias", (d,))]


def _linear(out, name, ci, co, bias=True):
    out.append((name + ".weight", (co, ci)))
    if bias:
        out.append((name + ".bias", (co,)))


def encoder_shapes(pre, d, inter, layers):
    out = []
    for i in range(layers):
        lp = f"{pre}.layers.{i}"
        _norm(out, lp + ".layer_norm1", d)
        for n in ("q", "k", "v", "out"):
            _linear(out, f"{lp}.self_attn.{n}_proj", d, d)
        _norm(out, lp + ".layer_norm2", d)
        _linear(out, lp + ".mlp.fc1", d, inter)
        _linear(out, lp + ".mlp.fc2", inter, d)
    return out


def text_shapes(cfg):
    """transformers CLIPTextModel under `text_model.`."""
    d = cfg["hidden_size"]
    out = [("text_model.embeddings.token_embedding.weight",
            (cfg["vocab_size"], d)),
           ("text_model.embeddings.position_embedding.weight",
            (cfg["max_position_embeddings"], d))]
    out += encoder_shapes("text_model.encoder", d, cfg["intermediate_size"],
                          cfg["num_hidden_layers"])
    _norm(out, "text_model.final_layer_norm", d)
    return out


def clip_shapes(cfg):
    """transformers CLIPModel: both towers, projections, logit scale."""
    v, t = cfg["vision_config"], cfg["text_config"]
    d, ps = v["hidden_size"], v["patch_size"]
    grid = (v["image_size"] // ps) ** 2 + 1
    out = [("vision_model.embeddings.patch_embedding.weight", (d, 3, ps, ps)),
           ("vision_model.embeddings.class_embedding", (d,)),
           ("vision_model.embeddings.position_embedding.weight", (grid, d))]
    _norm(out, "vision_model.pre_layrnorm", d)
    out += encoder_shapes("vision_model.encoder", d, v["intermediate_size"],
                          v["num_hidden_layers"])
    _norm(out, "vision_model.post_layernorm", d)
    _linear(out, "visual_projection", d, cfg["projection_dim"], bias=False)
    out += text_shapes(t)
    _linear(out, "text_projection", t["hidden_size"], cfg["projection_dim"],
            bias=False)
    out.append(("logit_scale", ()))
    return out


def lpips_shapes():
    """torchvision vgg16 `features.<i>` and the LPIPS heads."""
    out, ci = [], 3
    for (co, n), idxs in zip(VGG_PLAN, VGG_FEATURES):
        for j in idxs[:n]:
            out += [(f"features.{j}.weight", (co, ci, 3, 3)),
                    (f"features.{j}.bias", (co,))]
            ci = co
    for i, (co, _) in enumerate(VGG_PLAN):
        out.append((f"lin{i}.model.1.weight", (1, co, 1, 1)))
    return out


def head_shapes(cfg):
    """The discriminator heads: (name, weight shape)."""
    d, hc = cfg["vision_config"]["hidden_size"], HEAD_CHANNELS
    out = []
    for i in range(2):
        out += [(f"spatial.{i}.conv1", (hc, d, 3, 3)),
                (f"spatial.{i}.conv2", (1, hc, 1, 1))]
    return out + [("final.lin1", (hc, cfg["projection_dim"])),
                  ("final.lin2", (1, hc))]
