"""Gradio demos (canny2image and sketch2image) on the port's pipeline
(counterpart of `img2img_turbo_tpu/serving/demo.py`; the reference's
gradio_canny2image.py / gradio_sketch2image.py).

`CannyDemo.process` and `SketchDemo.run` take a PIL image and return PIL
images, computing on the card the `Pix2PixTurbo` they are given lives on
(canny on the device, the kernel path, one uint8 copy back). gradio is an
optional dependency, installed neither here nor on the card machine: the
process functions are importable and testable without it, and `launch_*`
raises a clear error when it is absent. `serving/web_demo.py` serves the
same two functions over the standard library's HTTP server.
"""

from __future__ import annotations

import numpy as np
import torch

# style prompt templates (the reference demo's, gradio_sketch2image.py:15-52)
STYLE_LIST = [
    ("Cinematic", "cinematic still {prompt} . emotional, harmonious, "
     "vignette, highly detailed, high budget, bokeh, cinemascope, moody, "
     "epic, gorgeous, film grain, grainy"),
    ("3D Model", "professional 3d model {prompt} . octane render, highly "
     "detailed, volumetric, dramatic lighting"),
    ("Anime", "anime artwork {prompt} . anime style, key visual, vibrant, "
     "studio anime,  highly detailed"),
    ("Digital Art", "concept art {prompt} . digital artwork, illustrative, "
     "painterly, matte painting, highly detailed"),
    ("Photographic", "cinematic photo {prompt} . 35mm photograph, film, "
     "bokeh, professional, 4k, highly detailed"),
    ("Pixel art", "pixel-art {prompt} . low-res, blocky, pixel art style, "
     "8-bit graphics"),
    ("Fantasy art", "ethereal fantasy concept art of  {prompt} . "
     "magnificent, celestial, ethereal, painterly, epic, majestic, magical, "
     "fantasy art, cover art, dreamy"),
    ("Neonpunk", "neonpunk style {prompt} . cyberpunk, vaporwave, neon, "
     "vibes, vibrant, stunningly beautiful, crisp, detailed, sleek, "
     "ultramodern, magenta highlights, dark purple shadows, high contrast, "
     "cinematic, ultra detailed, intricate, professional"),
    ("Manga", "manga style {prompt} . vibrant, high-energy, detailed, "
     "iconic, Japanese comic style"),
]
STYLES = dict(STYLE_LIST)
DEFAULT_STYLE = "Fantasy art"


def apply_style(style_name: str, prompt: str) -> str:
    return STYLES.get(style_name, "{prompt}").replace("{prompt}", prompt)


class CannyDemo:
    """process(): image + prompt + thresholds -> (inverted edge map,
    translated image), PIL. `pipe`: a `Pix2PixTurbo` with merged params,
    its text encoder and tokenizer; the posterior noise is drawn from a
    generator seeded 0 (demo.py:58-75)."""

    def __init__(self, pipe):
        self.pipe = pipe

    @torch.no_grad()
    def process(self, input_image, prompt: str, low_threshold: int,
                high_threshold: int):
        from PIL import Image
        from img2img_turbo_tpu_torch.ops import canny as canny_mod
        from img2img_turbo_tpu_torch.ops import image as image_mod

        img = input_image.convert("RGB")
        new_w, new_h = img.width - img.width % 8, img.height - img.height % 8
        img = img.resize((new_w, new_h))
        arr = torch.from_numpy(np.array(img, np.uint8))[None].to(
            self.pipe.device)
        c_t = canny_mod.canny_3ch_unit(arr, float(low_threshold),
                                       float(high_threshold))
        out = self.pipe(c_t.to(self.pipe.dtype), prompt=prompt)
        u8 = image_mod.signed_to_uint8(out)[0].cpu().numpy()
        canny_viz = 255 - (c_t[0].float() * 255).cpu().numpy().astype(
            np.uint8)
        return Image.fromarray(canny_viz), Image.fromarray(u8)


class SketchDemo:
    """run(): canvas sketch + prompt / style / seed / r -> image, PIL, on the
    stochastic path (reference gradio_sketch2image.py:67-91; demo.py:78-
    102). `pipe`: a `Pix2PixTurbo` with base + factored LoRA (a TwinConv
    conv_in); the noise map, then the posterior noise, are drawn from a
    generator seeded `seed` on the pipeline's device."""

    def __init__(self, pipe):
        self.pipe = pipe

    @torch.no_grad()
    def run(self, image, prompt: str, prompt_template_name: str, seed: int,
            val_r: float):
        from PIL import Image
        from img2img_turbo_tpu_torch.ops import image as image_mod

        prompt = apply_style(prompt_template_name, prompt)
        img = image.convert("RGB")
        w, h = img.width - img.width % 8, img.height - img.height % 8
        img = img.resize((w, h))
        dev = self.pipe.device
        unit = image_mod.uint8_to_unit(
            torch.from_numpy(np.array(img, np.uint8))[None].to(dev))
        c_t = (unit > 0.5).to(self.pipe.dtype)
        g = torch.Generator(device=dev).manual_seed(int(seed))
        noise = torch.randn((1, h // 8, w // 8, 4), generator=g, device=dev,
                            dtype=self.pipe.dtype)
        out = self.pipe(c_t, prompt=prompt, deterministic=False,
                        r=float(val_r), noise_map=noise, generator=g)
        u8 = image_mod.signed_to_uint8(out)[0].cpu().numpy()
        return Image.fromarray(u8)


def _require_gradio():
    try:
        import gradio
        return gradio
    except ImportError as e:
        raise RuntimeError(
            "gradio is not installed in this environment; the demo logic is "
            "available via CannyDemo/SketchDemo for programmatic use"
        ) from e


def launch_canny_demo(pipe, **launch_kwargs):
    gr = _require_gradio()
    demo_obj = CannyDemo(pipe)
    with gr.Blocks() as demo:
        with gr.Row():
            prompt = gr.Textbox(label="Prompt")
        with gr.Row():
            inp = gr.Image(type="pil", label="Input")
            edges = gr.Image(type="pil", label="Canny")
            out = gr.Image(type="pil", label="Output")
        low = gr.Slider(1, 255, value=100, step=1, label="Canny low")
        high = gr.Slider(1, 255, value=200, step=1, label="Canny high")
        btn = gr.Button("Run")
        btn.click(demo_obj.process, [inp, prompt, low, high], [edges, out])
    return demo.launch(**launch_kwargs)


def launch_sketch_demo(pipe, **launch_kwargs):
    gr = _require_gradio()
    demo_obj = SketchDemo(pipe)
    with gr.Blocks() as demo:
        prompt = gr.Textbox(label="Prompt")
        style = gr.Dropdown(list(STYLES), value=DEFAULT_STYLE, label="Style")
        seed = gr.Number(value=42, label="Seed")
        gamma = gr.Slider(0.0, 1.0, value=0.4, label="Sketch guidance (r)")
        inp = gr.Image(type="pil", label="Sketch")
        out = gr.Image(type="pil", label="Output")
        for ctrl in (inp, prompt, style, seed, gamma):
            ctrl.change(demo_obj.run, [inp, prompt, style, seed, gamma],
                        [out])
    return demo.launch(**launch_kwargs)
