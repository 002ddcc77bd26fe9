"""The comparison must fail a run whose timed path is broken. Each test
skips the harness's look for a card and drives the rest of a run on the
CPU at tiny widths, with the program broken underneath, once for each
fault the cell can have. Serving: an answer altered where it is produced;
half of the batch left out (the other half served in its place).
Training: a step that leaves its state unchanged; half of the batch left
out, the mean taken over the rest; the generator's image altered where it
is produced. The same runs unbroken are correct."""

import pytest
import torch

from port_bench import run
from port_bench.tests.tiny import TINY_TRAFFIC, tiny_cfg

SERVE = ["edge_b8_512", "day2night_b2_720p"]
TRAIN = ["edge_train_b4_512"]
TRAIN_TRAFFIC = {"batch": 2, "height": 64, "width": 64, "pool_batches": 3}


def _run(cell):
    c = run.Cell(run.ROOT, cell)
    traffic = TRAIN_TRAFFIC if cell in TRAIN else TINY_TRAFFIC
    return run.run_cell(run.ROOT, cell, 2 ** 31 + 77, 0.3, 0, "cpu",
                        dtype=torch.float32, cfg_override=tiny_cfg(c.cfg),
                        traffic_override=traffic)[1]


def _altered(orig):
    def fn(*args, **kw):
        res = orig(*args, **kw)
        res["img"] = res["img"].clone()
        res["img"][0, :8] += 0.25
        return res
    return fn


def _half_batch(orig):
    def fn(unet, vae, cfgs, alphas, c_t, caption_enc, **kw):
        h = c_t.shape[0] // 2
        if kw.get("noise") is not None:
            kw["noise"] = kw["noise"][:h]
        res = orig(unet, vae, cfgs, alphas, c_t[:h], caption_enc[:h], **kw)
        return {k: torch.cat([v, v]) for k, v in res.items()}
    return fn


def _train_unchanged(monkeypatch):
    from img2img_turbo_tpu_torch.training import paired
    monkeypatch.setattr(paired, "_apply", lambda opt, params, grads: None)


def _train_half_batch(monkeypatch):
    from img2img_turbo_tpu_torch.training import accum
    orig = accum.accumulated_grads

    def half(loss_fn, params, data, steps):
        b = next(iter(data.values())).shape[0]
        return orig(loss_fn, params, {k: v[:b // 2] for k, v in data.items()},
                    steps)
    monkeypatch.setattr(accum, "accumulated_grads", half)


def _train_altered(monkeypatch):
    from img2img_turbo_tpu_torch.training import paired
    orig = paired.generate_deterministic

    def altered(*args, **kw):
        out = orig(*args, **kw)
        return torch.cat([out[:1] * 0.9, out[1:]])
    monkeypatch.setattr(paired, "generate_deterministic", altered)


@pytest.mark.parametrize("cell", SERVE + TRAIN)
def test_sound_run_is_correct(cell):
    line = _run(cell)
    assert line["correct"], line["checks"]


@pytest.mark.parametrize("fault", [_altered, _half_batch])
@pytest.mark.parametrize("cell", SERVE)
def test_broken_serving_is_not_correct(cell, fault, monkeypatch):
    from img2img_turbo_tpu_torch.serving import engine
    monkeypatch.setattr(engine, "generate_unclamped",
                        fault(engine.generate_unclamped))
    line = _run(cell)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("fault", [_train_unchanged, _train_half_batch,
                                   _train_altered])
@pytest.mark.parametrize("cell", TRAIN)
def test_broken_training_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    line = _run(cell)
    assert not line["correct"], line["checks"]
