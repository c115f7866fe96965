"""What the benchmark loads: nothing of JAX or of the JAX package (top-level
names compared whole, since the program's name begins with the JAX
package's), and the reference nothing of the program either."""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def loaded_after(imports: str):
    code = (f"import sys\nsys.path.insert(0, {ROOT!r})\n{imports}\n"
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, env=dict(os.environ, USE_FLAX="0"))
    return set(out.stdout.split())


def test_harness_and_reference_load_no_jax():
    top = loaded_after(
        "import benchmark.run, benchmark.calibrate\n"
        "from benchmark.harness import cell, configs, costs, judge, manifest, readers, scenes, "
        "spans, trace, traffic, weights\n"
        "from benchmark.reference.models import fsf\nfrom benchmark.reference import train\n"
        "import json\ncfg = json.load(open("
        f"{os.path.join(ROOT, 'benchmark', 'configs', 'fsf_nusc.json')!r}))\n"
        "manifest.family(cfg).program_config(cfg)")
    assert not top & {"jax", "jaxlib", "flax", "fullysparsefusion_tpu"}
    assert "fullysparsefusion_tpu_torch" in top          # the program itself, by design


def test_reference_loads_nothing_of_the_program():
    top = loaded_after("from benchmark.reference.models import fsf\n"
                       "from benchmark.reference import train, precision")
    assert "fullysparsefusion_tpu_torch" not in top
    assert not top & {"jax", "jaxlib", "flax", "fullysparsefusion_tpu"}


def test_forbidden_names_compare_whole():
    sys.path.insert(0, ROOT)
    from benchmark import run

    before = run.forbidden_modules()
    sys.modules["fullysparsefusion_tpu_torch_x"] = object()
    try:
        assert run.forbidden_modules() == before
        sys.modules["fullysparsefusion_tpu.models"] = object()
        assert "fullysparsefusion_tpu" in run.forbidden_modules()
    finally:
        sys.modules.pop("fullysparsefusion_tpu_torch_x")
        sys.modules.pop("fullysparsefusion_tpu.models", None)
