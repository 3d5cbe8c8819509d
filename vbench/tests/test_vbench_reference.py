"""The plain references against the program, on the CPU: the same function
at a tiny size (SWIN-T BiRefNet at 64x64, a two-block RRDBNet), the same
FLOP count at full width, and weights whose served answers spread over
their range.

    python -m pytest vbench/tests -q
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from vbench.configs import birefnet_swinl_1024 as biref_cfg
from vbench.configs import esrgan_x4plus as esrgan_cfg
from vbench.harness import _flops_counter
from vbench.reference import birefnet_swinl_1024 as biref_ref
from vbench.reference import esrgan_x4plus as esrgan_ref
from vbench.weights import draw, image_pool

ROOT = Path(__file__).resolve().parents[2]
SWIN_T = {"embed_dim": 96, "depths": [2, 2, 6, 2], "num_heads": [3, 6, 12, 24], "window_size": 7}
ATOL = 2e-5  # float32 on both sides: summation order only

torch.set_num_threads(2)


def _cfg(name: str, **over) -> dict:
    cfg = json.loads((ROOT / "vbench" / "configs" / f"{name}.json").read_text())
    cfg.update(over)
    return cfg


def _images(seed, n, w, h):
    return torch.from_numpy(np.stack(image_pool(seed, "test", n, w, h, "cpu")))


def test_esrgan_reference_matches_the_program_at_two_blocks():
    cfg = _cfg("esrgan_x4plus", num_block=2)
    weights = draw(esrgan_cfg.weight_specs(cfg), 21, "cpu")
    server = esrgan_cfg.build(dict(weights), cfg, "cpu")
    try:
        x = _images(21, 2, 20, 16)
        program = server.model._forward_u8(x, to_u8=False).float()
        served = np.stack([esrgan_cfg.result_pixels(server.compute(esrgan_cfg.request(a.numpy()))) for a in x])
    finally:
        server.close()
    reference = esrgan_ref.forward(weights, x, cfg)
    assert program.shape == reference.shape == (2, 64, 80, 3)
    assert (program - reference).abs().max().item() < ATOL
    expected = esrgan_ref.expected_u8(weights, x, cfg).numpy()
    assert np.abs(served.astype(int) - expected.astype(int)).max() <= 1


def test_birefnet_reference_matches_the_program_with_swin_t_at_64():
    cfg = _cfg("birefnet_swinl_1024", image_size=64, swin=SWIN_T)
    weights = draw(biref_cfg.weight_specs(cfg), 22, "cpu")
    server = biref_cfg.build(dict(weights), cfg, "cpu")
    try:
        x = _images(22, 2, 64, 64)
        program = server.model._forward_u8(x).float()[..., 0]
        served = np.stack([biref_cfg.result_pixels(server.compute(biref_cfg.request(a.numpy()))) for a in x])
    finally:
        server.close()
    reference = biref_ref.forward(weights, x, cfg)
    assert (program - reference).abs().max().item() < ATOL
    expected = biref_ref.expected_u8(weights, x, cfg).numpy()
    assert served.shape == expected.shape == (2, 64, 64, 1)
    assert np.abs(served.astype(int) - expected.astype(int)).max() <= 1


@pytest.mark.parametrize("name,extent", [("esrgan_x4plus", (512, 512)), ("esrgan_x4plus", (480, 320)),
                                         ("birefnet_swinl_1024", (1024, 1024))])
def test_reference_flops_match_the_programs_count_at_full_width(name, extent):
    """The yardstick's FLOPs (FlopCounterMode on meta tensors over the
    reference) within 0.5% of the program's own count (utils/flops.py), at
    the widths the cells run."""
    from vision_tpu_torch.utils.flops import count_flops

    mods = {"esrgan_x4plus": (esrgan_cfg, esrgan_ref), "birefnet_swinl_1024": (biref_cfg, biref_ref)}
    builder, reference = mods[name]
    cfg = _cfg(name)
    specs = builder.weight_specs(cfg)
    ours = _flops_counter(reference, specs, cfg)(extent)
    weights = {n: torch.zeros(shape) for n, shape, _, _ in specs}
    server = builder.build(weights, cfg, "cpu")
    try:
        x = torch.zeros((1, extent[1], extent[0], 3), dtype=torch.uint8)
        theirs = count_flops(server.model._forward_u8, x)
    finally:
        server.close()
    assert ours == pytest.approx(theirs, rel=5e-3), (ours / 1e9, theirs / 1e9)


def test_esrgan_weights_give_served_pixels_a_spread():
    """Full depth and width at 32x32: the served pixels cover the middle of
    their range (the program's own random weights serve all zeros)."""
    cfg = _cfg("esrgan_x4plus")
    server = esrgan_cfg.build(draw(esrgan_cfg.weight_specs(cfg), 23, "cpu"), cfg, "cpu")
    try:
        px = [esrgan_cfg.result_pixels(server.compute(esrgan_cfg.request(a))) for a in image_pool(23, "t", 2, 32, 32,
                                                                                                  "cpu")]
    finally:
        server.close()
    rgb = np.stack(px)[..., :3].astype(np.float64)
    assert rgb.std() > 20 and 40 < rgb.mean() < 215
    assert ((rgb == 0) | (rgb == 255)).mean() < 0.5


def test_birefnet_weights_give_served_mattes_a_spread():
    """SWIN-L and the full decoder at 128x128: the served mattes are no
    constant and not saturated."""
    cfg = _cfg("birefnet_swinl_1024", image_size=128)
    server = biref_cfg.build(draw(biref_cfg.weight_specs(cfg), 24, "cpu"), cfg, "cpu")
    try:
        mattes = [biref_cfg.result_pixels(server.compute(biref_cfg.request(a)))
                  for a in image_pool(24, "t", 2, 128, 128, "cpu")]
    finally:
        server.close()
    m = np.stack(mattes).astype(np.float64)
    assert m.std() > 20 and ((m == 0) | (m == 255)).mean() < 0.5
