"""No JAX in the benchmark's process, and nothing of the program in the
reference, by whole top-level module names."""

import subprocess
import sys

from port_bench import run

JAXLIKE = ("jax", "jaxlib", "flax", "img2img_turbo_tpu")


def _loaded(code: str):
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.split()


def test_forbidden_names_compare_whole_top_level_names():
    assert run.FORBIDDEN == JAXLIKE
    assert run.forbidden_modules(["img2img_turbo_tpu_torch.ops._build",
                                  "jaxtyping", "flaxen", "torch"]) == []
    assert run.forbidden_modules(["jax.numpy", "img2img_turbo_tpu.ops",
                                  "flax.linen", "jaxlib"]) == list(
        sorted(JAXLIKE))


def test_reference_imports_nothing_of_the_program():
    tops = _loaded(
        "import sys\n"
        "import port_bench.reference.generator, port_bench.compare\n"
        "import port_bench.flops, port_bench.roofline, port_bench.weights\n"
        "import port_bench.inputs, port_bench.trace\n"
        "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    assert not set(tops) & set(JAXLIKE + ("img2img_turbo_tpu_torch",))


def test_tiny_run_loads_no_jax():
    tops = _loaded(
        "import sys, torch\n"
        "from port_bench import run\n"
        "from port_bench.tests.tiny import TINY_TRAFFIC, tiny_cfg\n"
        "c = run.Cell(run.ROOT, 'edge_b8_512')\n"
        "rec, line, _ = run.run_cell(run.ROOT, 'edge_b8_512', 2**31 + 9, "
        "0.2, 1, 'cpu', dtype=torch.float32, cfg_override=tiny_cfg(c.cfg),"
        " traffic_override=TINY_TRAFFIC)\n"
        "assert line['correct'], line\n"
        "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    assert "img2img_turbo_tpu_torch" in tops
    assert not set(tops) & set(JAXLIKE)
