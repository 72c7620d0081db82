"""Each CUDA kernel of the port against its plain torch version on the card,
at the main path's shapes (the checks of chip_smoke.py phase 3). Skipped
without a card. This file imports no jax, so it also runs on a machine
without the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("kernel", ["sobol_block", "isect", "accum", "shade", "surface", "traverse",
                                    "surface_v2"])
def test_kernel_matches_plain_on_card(cuda_device, kernel):
    import chip_smoke

    check = {"sobol_block": chip_smoke.check_sobol, "isect": chip_smoke.check_isect,
             "accum": chip_smoke.check_accum, "shade": chip_smoke.check_shade,
             "surface": chip_smoke.check_surface, "traverse": chip_smoke.check_traverse,
             "surface_v2": chip_smoke.check_surface_v2}[kernel]
    result = check(cuda_device)  # raises on any disagreement
    assert result["ms"] > 0.0
