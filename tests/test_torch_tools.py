"""The port's remaining modules against the JAX package's, on the CPU in
fp32: the demos' styles and gradio launchers (`serving/demo.py`), the web
demo (`serving/web_demo.py`), the parity CLI (`cli/accept_parity.py`),
the native reader's refusal (`weights/native.py`) and the profiling
helpers (`utils/profiling.py`). The demos' images and `convert_weights`
against JAX run in tests/test_torch_inference.py, on its JAX pipelines,
compiled there once.

The web demo serves a random MICRO pix2pix-turbo (merged weights beside
the factored ones with a TwinConv conv_in, prompts through the word-hash
tokenizer) headless on port 0; each endpoint's JSON must equal the direct
call's. LPIPS agrees with JAX's within 1e-5.
"""

import contextlib
import importlib.util
import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from img2img_turbo_tpu.serving import demo as jdemo
from img2img_turbo_tpu.serving import web_demo as jweb
from img2img_turbo_tpu_torch import configs as tcfg
from img2img_turbo_tpu_torch.cli import accept_parity
from img2img_turbo_tpu_torch.models.unet import make_twin_conv_in
from img2img_turbo_tpu_torch.pipelines import pix2pix as tp2p
from img2img_turbo_tpu_torch.serving import demo as tdemo
from img2img_turbo_tpu_torch.serving import web_demo as tweb
from img2img_turbo_tpu_torch.training.runner import SmokeTokenizer
from img2img_turbo_tpu_torch.utils import profiling as tprof
from img2img_turbo_tpu_torch.weights import native
from img2img_turbo_tpu_torch.weights import torch_import as ti

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 40, 64
PROMPT = "a red bird"


@pytest.fixture(scope="module")
def pipe():
    """A random MICRO pix2pix-turbo holding both the merged weights (canny)
    and the factored ones with a TwinConv conv_in (sketch)."""
    cfgs = tp2p.GeneratorConfigs(tcfg.MICRO_UNET, tcfg.TINY_VAE,
                                 tcfg.TINY_TEXT)
    p = tp2p.Pix2PixTurbo.from_random(torch.Generator().manual_seed(70),
                                      cfgs, dtype=torch.float32)
    g = torch.Generator().manual_seed(71)
    for lora in p.lora.values():
        for e in lora["modules"].values():
            e["b"] = torch.randn(e["b"].shape, generator=g) * 0.05
    p.merge()
    make_twin_conv_in(p.base["unet"])
    p.tokenizer = SmokeTokenizer(cfgs.text.vocab_size)
    return p


def _image(seed):
    rng = np.random.RandomState(seed)
    return Image.fromarray((rng.rand(H, W, 3) * 255).astype(np.uint8))


# ---------------------------------------------------------------------------
# the demos
# ---------------------------------------------------------------------------


def test_styles_equal_jax():
    assert tdemo.STYLE_LIST == jdemo.STYLE_LIST
    assert tdemo.STYLES == jdemo.STYLES
    assert tdemo.DEFAULT_STYLE == jdemo.DEFAULT_STYLE
    for name in list(jdemo.STYLES) + ["no such style"]:
        assert tdemo.apply_style(name, "a cat") == \
            jdemo.apply_style(name, "a cat")


@pytest.mark.parametrize("launch", ["canny", "sketch"])
def test_gradio_launchers_refuse_without_gradio(launch):
    with pytest.raises(RuntimeError, match="gradio is not installed"):
        getattr(tdemo, f"launch_{launch}_demo")(None)


# ---------------------------------------------------------------------------
# the web demo
# ---------------------------------------------------------------------------


def _post(port, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def test_web_demo_pages_and_endpoints_equal_direct_calls(pipe):
    """Served headless on port 0: both pages (the JAX module's, naming the
    GPU), each endpoint's JSON equal to the direct call's, and an error
    answered as JSON with status 500."""
    server, port = tweb.launch_in_thread(pipe)
    try:
        for path, page in (("/", jweb._render_page()),
                           ("/canny", jweb._CANNY_PAGE)):
            with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                        timeout=60) as resp:
                assert resp.status == 200
                assert resp.read().decode() == page.replace("TPU", "GPU")
        img = _image(62)
        url = tweb._encode_data_url(img)
        code, got = _post(port, "/api/canny", {"image": url, "prompt": PROMPT,
                                               "low": 90, "high": 180})
        edges, out = tdemo.CannyDemo(pipe).process(img, PROMPT, 90, 180)
        assert code == 200 and got == {"edges": tweb._encode_data_url(edges),
                                       "image": tweb._encode_data_url(out)}
        code, got = _post(port, "/api/sketch", {
            "image": url, "prompt": PROMPT, "style": "Manga", "seed": 3,
            "r": 0.6})
        out = tdemo.SketchDemo(pipe).run(img, PROMPT, "Manga", 3, 0.6)
        assert code == 200 and got == {"image": tweb._encode_data_url(out)}
        code, got = _post(port, "/api/canny", {"image": "data:,"})
        assert code == 500 and set(got) == {"error"}
    finally:
        server.shutdown()
        server.server_close()


# ---------------------------------------------------------------------------
# accept_parity
# ---------------------------------------------------------------------------


def _jax_cli(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "cli", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_accept_parity_lpips_equals_jax():
    """The port's LPIPS value (seeded random weights, converted for JAX)
    against the JAX harness's `_lpips_value` on the same two images."""
    from img2img_turbo_tpu.models import vgg_lpips as jvgg
    model = accept_parity._lpips_model("", torch.device("cpu"))
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    conv_idx = [[0, 2], [5, 7], [10, 12, 14], [17, 19, 21], [24, 26, 28]]
    vgg = {f"features.{idx}.{leaf}": sd[f"blocks.{i}.{j}.{leaf}"]
           for i, idxs in enumerate(conv_idx)
           for j, idx in enumerate(idxs) for leaf in ("weight", "bias")}
    lins = {f"lin{i}.model.1.weight": sd[f"lins.{i}.weight"]
            for i in range(5)}
    rng = np.random.RandomState(3)
    ours = rng.uniform(-1, 1, (1, 48, 64, 3)).astype(np.float32)
    ref = np.clip(ours + 0.2 * rng.randn(*ours.shape), -1, 1).astype(
        np.float32)
    want = _jax_cli("accept_parity")._lpips_value(
        jvgg.convert_lpips_state_dict(vgg, lins), ours, ref, True)
    got = accept_parity.lpips_value(model, ours, ref)
    assert abs(got - want) <= 1e-5, (got, want)
    assert got > 1e-3


def test_accept_parity_tiny_random_prints_jax_keys(capsys):
    args = accept_parity.build_parser().parse_args(["--tiny_random"])
    assert vars(args) == vars(_jax_cli("accept_parity").build_parser()
                              .parse_args(["--tiny_random"]))
    res = accept_parity.main(args, device="cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == res
    # the keys of the JAX harness's result line (cli/accept_parity.py)
    assert list(line) == ["lpips", "threshold", "pass", "mode",
                          "lpips_weights", "plumbing_only"]
    assert line["threshold"] == 0.05 and line["plumbing_only"] is True
    assert line["mode"] == "deterministic" and np.isfinite(line["lpips"])


def test_accept_parity_needs_its_files():
    args = accept_parity.build_parser().parse_args(["--prompt", "p"])
    with pytest.raises(SystemExit, match="--sd_turbo_path is required"):
        accept_parity.main(args, device="cpu")


# ---------------------------------------------------------------------------
# convert_weights and the native checkpoint
# ---------------------------------------------------------------------------


def test_native_reader_refuses_other_files(tmp_path):
    path = str(tmp_path / "x.safetensors")
    ti.save_safetensors({"w": torch.zeros(2)}, path)
    with pytest.raises(ValueError, match="not a native checkpoint"):
        native.load_native(path, device="cpu")


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------


def test_spans_off_record_nothing():
    """Off, every span is one shared null context; a recorder keeps only
    what ran while it was open."""
    null = tprof.span("i2i.a")
    assert isinstance(null, contextlib.nullcontext)
    assert tprof.span("i2i.b", unit=True) is null
    with tprof.recording() as rec:
        with tprof.span("i2i.a", unit=True):
            pass
    assert tprof.span("i2i.a") is null
    with tprof.span("i2i.a", unit=True):
        pass
    assert [s.name for s in rec.spans] == ["i2i.a"] and rec.units == 1


def _ms_clock():
    ticks = iter(range(10 ** 6))
    return lambda: next(ticks) * 10 ** 6


def test_spans_nest_with_parents_self_time_and_unit_ids(monkeypatch):
    """On a clock that advances 1 ms a reading: each request's spans carry
    its id and their parents; self time leaves the children out; the
    table divides by the requests; the buffer keeps the last MAX_SPANS
    spans while the table counts every one."""
    monkeypatch.setattr(tprof, "MAX_SPANS", 6)
    with tprof.recording(clock=_ms_clock()) as rec:
        for _ in range(2):
            with tprof.span("i2i.req", unit=True):      # 0 .. 7
                with tprof.span("i2i.a"):               # 1 .. 4
                    with tprof.span("i2i.b"):           # 2 .. 3
                        pass
                with tprof.span("i2i.c"):               # 5 .. 6
                    pass
    spans = list(rec.spans)
    assert len(spans) == 6 and [s.name for s in spans[-4:]] == [
        "i2i.b", "i2i.a", "i2i.c", "i2i.req"]
    b, a, c, req = spans[-4:]
    assert req.parent is None and a.parent == c.parent == req.seq
    assert b.parent == a.seq and {s.unit for s in spans[-4:]} == {2}
    assert spans[0].unit == 1 and (req.start_ns, req.end_ns) == (8e6, 15e6)
    table = rec.table("i2i.req")
    assert table["units"] == 2
    assert table["spans"] == {
        "i2i.req": {"count": 1.0, "host_ms": 7.0, "self_ms": 3.0},
        "i2i.a": {"count": 1.0, "host_ms": 3.0, "self_ms": 2.0},
        "i2i.b": {"count": 1.0, "host_ms": 1.0, "self_ms": 1.0},
        "i2i.c": {"count": 1.0, "host_ms": 1.0, "self_ms": 1.0}}


class _Twice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x * 2

    @staticmethod
    def backward(ctx, g):
        with tprof.span("i2i.in_backward"):
            return g * 2


def test_a_span_in_the_backward_belongs_to_the_callers_span():
    """A span opened in a backward, on the caller's thread (the CPU) or
    on a thread of its own (autograd's device thread on a card), takes
    the span open around `autograd.grad` as its parent."""
    x = torch.ones(3, requires_grad=True)
    with tprof.recording() as rec:
        with tprof.span("i2i.step", unit=True):
            y = _Twice.apply(x).sum()
            with tprof.span("i2i.backward"):
                torch.autograd.grad(y, [x])
                worker = threading.Thread(
                    target=lambda: _Twice.backward(None, torch.ones(1)))
                worker.start()
                worker.join()
    by = {s.seq: s for s in rec.spans}
    inner = [s for s in rec.spans if s.name == "i2i.in_backward"]
    assert len(inner) == 2 and len({s.thread for s in inner}) == 2
    assert all(by[s.parent].name == "i2i.backward" and s.unit == 1
               for s in inner)
    assert by[by[inner[0].parent].parent].name == "i2i.step"


def test_counters_reset_when_recording_opens():
    tprof.count("test.items", 5)
    with tprof.recording() as rec:
        assert tprof.counts["test.items"] == 0
        for n in (1, 3):
            with tprof.span("i2i.req", unit=True):
                tprof.count("test.items", n)
    tprof.count("test.items", 7)
    assert rec.counters() == {"test.items": 4}
    assert rec.table("i2i.req")["counters"] == {"test.items": 2.0}
    assert rec.table("i2i.none") == {"per": "i2i.none", "units": 0,
                                     "spans": {}, "counters": {}}


def test_trace_writes_a_chrome_trace(tmp_path):
    with tprof.trace(str(tmp_path)):
        torch.randn(32, 32) @ torch.randn(32, 32)
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as f:
        assert json.load(f)["traceEvents"]


def test_device_helpers_find_nothing_without_a_card():
    """On the CPU the profile records no device event: {} as JAX returns
    without a device track; no card, no memory stats."""
    calls = []
    out = tprof.device_time_per_call(lambda x: calls.append(x) or x * 2,
                                     (torch.ones(3),), iters=3)
    assert out == {} and len(calls) == 4
    assert tprof.device_memory_stats() == {}


def test_quickstart_runs_the_three_modes_on_the_cpu():
    """examples/quickstart_torch.py, the port's counterpart of
    examples/quickstart.py, runs edge_to_image, sketch and image mode
    through the port's API on the CPU: each output (1, 64, 64, 3), the
    pipelines' in [-1, 1], the engine's uint8; it imports nothing of the
    JAX package."""
    path = os.path.join(REPO, "examples", "quickstart_torch.py")
    with open(path) as f:
        src = f.read()
    assert "jax" not in src and "img2img_turbo_tpu." not in src
    spec = importlib.util.spec_from_file_location("quickstart_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = mod.main("cpu")
    assert set(out) == {"edge_to_image", "sketch", "image"}
    for name, y in out.items():
        assert tuple(y.shape) == (1, 64, 64, 3), name
    for name in ("edge_to_image", "sketch"):
        y = out[name]
        assert y.dtype == torch.float32 and torch.isfinite(y).all()
        assert float(y.abs().max()) <= 1.0
    assert out["image"].dtype == torch.uint8
