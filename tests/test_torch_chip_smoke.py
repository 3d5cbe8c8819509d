"""chip_smoke.py checks and times the flash kernel at the token counts the
Depth-Anything requests it serves really reach: its request extents are one
module-level constant, and the token counts come from the model's own
depthany_image_extent, so no literal can drift from the served shape."""

import importlib.util
from pathlib import Path

import pytest

from vision_tpu.models.depth_anything import DepthAnythingParams as JaxParams
from vision_tpu.models.depth_anything import depthany_image_extent as jax_image_extent


@pytest.fixture(scope="module")
def chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_module", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)  # defines only; main() is not run
    return module


def test_depth_tokens_are_the_served_extents(chip_smoke):
    assert chip_smoke.DEPTH_EXTENTS == ((518, 518), (700, 500))
    assert [chip_smoke.depth_tokens(e) for e in chip_smoke.DEPTH_EXTENTS] == [1370, 1925]


@pytest.mark.parametrize("extent", [(518, 518), (700, 500), (500, 700), (1024, 768)])
def test_depth_tokens_follow_the_reference_extent(chip_smoke, extent):
    """The same count the JAX package's extent rule gives (patch 14, one class token)."""
    w, h = jax_image_extent(extent, JaxParams())
    assert chip_smoke.depth_tokens(extent) == (w // 14) * (h // 14) + 1
