"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level names, and the reference imports nothing of the program."""

import subprocess
import sys

import pytest

from benchmark.run import forbidden_modules
from benchmark.tests.conftest import ROOT


@pytest.mark.parametrize("names,found", [
    (["nebulae_tpu_torch", "nebulae_tpu_torch.engine.renderer", "numpy"], []),
    (["nebulae_tpu.config"], ["nebulae_tpu"]),
    (["jax", "jax.numpy"], ["jax"]),
    (["jaxlib.xla_client"], ["jaxlib"]),
    (["flax.linen", "nebulae_tpu_torchx"], ["flax"]),
    (["jaxtyping", "flaxen"], []),
])
def test_top_level_names_compared_whole(names, found):
    assert forbidden_modules(names) == found


def _loaded_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(' '.join(sorted({m.split('.')[0] "
                          "for m in sys.modules})))"], cwd=ROOT, capture_output=True, text=True, check=True)
    return set(out.stdout.split())


def test_harness_loads_neither_jax_nor_the_jax_package():
    tops = _loaded_after("import benchmark.run, benchmark.harness, benchmark.control\n"
                         "import nebulae_tpu_torch.engine.renderer, nebulae_tpu_torch.engine.train")
    assert not tops & {"jax", "jaxlib", "flax", "nebulae_tpu"}


def test_reference_imports_nothing_of_the_program():
    tops = _loaded_after("import benchmark.reference.frame, benchmark.reference.trace")
    assert "nebulae_tpu_torch" not in tops and "nebulae_tpu" not in tops and "jax" not in tops
