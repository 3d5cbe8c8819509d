"""SAM 3's image encoder in the benchmark, on the CPU: the check has teeth
(the float8 control fails the configuration's limit, and so does an answer
one pixel off, while the sound run passes), and the plain reference's FLOP
count at the published widths matches a count by hand. The runs go through
``harness.run`` at a small SAM3 (``config_overrides``); the harness's look
for a card is skipped (``device="cpu"``).

    python -m pytest vbench/tests -q
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from vbench import harness
from vbench.configs import sam3_vision_1008 as cell
from vbench.reference import sam3_vision_1008 as reference

ROOT = Path(__file__).resolve().parents[2]
WORKLOAD = "sam3_vision_1008.closed16_1008"
torch.set_num_threads(2)

# width 64, 4 heads, 4 layers (one global), 4x4 windows, 112x112 images, a
# 4x4 position table tiled 2x2, FPN 32; steps of 2^-6, so that a level's
# reference spread (1.1-2.1 at this size) is 70-130 steps, about the cell's
# 60-90
SMALL = dict(hidden_size=64, intermediate_size=256, num_hidden_layers=4, num_attention_heads=4, window_size=4,
             global_attn_indexes=[3], image_size=112, pretrain_image_size=56, fpn_hidden_size=32,
             server={"batch_size": 2}, check={"steps": [2.0**-6] * 4})
TRAFFIC = {"extents": [[112, 112, 1.0]], "clients": 2, "pool": 3, "lead_s": 0.1, "check_per_extent": 2}
SECONDS = 3.0


def _limit() -> float:
    return json.loads((ROOT / "vbench" / "configs" / "sam3_vision_1008.json").read_text())["check"]["limit"]


def test_the_float8_control_fails_the_limit():
    result = harness.run(WORKLOAD, 2**31 + 41, SECONDS, False, device="cpu", control=True, config_overrides=SMALL,
                         traffic_overrides=TRAFFIC)
    limit = _limit()
    assert result["correct"], result["checks"]  # the program in float32 on the CPU
    assert result["checks"]["rms_u8"]["value"] <= limit
    assert result["control_checks"]["rms_u8"] > limit, (result["control_checks"], limit)


def _roll_a_level(server):
    """Each answer's finest level one pixel off to the right, as an
    off-by-one where the answer is produced would leave it."""
    inner = server._server._fn

    def fn(items):
        out = inner(items)
        for answer in out:
            answer[0][...] = np.roll(answer[0], 1, axis=1)
        return out

    server._server._fn = fn


@pytest.mark.parametrize("fault", [None, _roll_a_level], ids=["sound", "level_rolled"])
def test_an_altered_answer_is_not_correct(fault):
    result = harness.run(WORKLOAD, 42, SECONDS, False, device="cpu", fault=fault, config_overrides=SMALL,
                         traffic_overrides=TRAFFIC)
    assert result["correct"] is (fault is None), result["checks"]


def test_the_reference_flops_at_full_width_match_the_count_by_hand():
    """At 1008x1008: the patch conv; 32 layers of q, k, v, o and the MLP
    (2 T (4 D^2 + 2 D F)); 28 window layers, 4 T 576 D; 4 global layers, 4
    T^2 D; the neck's three transposed convs and four 1x1 and 3x3 convs."""
    cfg = json.loads((ROOT / "vbench" / "configs" / "sam3_vision_1008.json").read_text())
    d, f, n_layers = cfg["hidden_size"], cfg["intermediate_size"], cfg["num_hidden_layers"]
    g = cfg["image_size"] // cfg["patch_size"]
    t, tok, fpn = g * g, cfg["window_size"] ** 2, cfg["fpn_hidden_size"]
    n_global = len(cfg["global_attn_indexes"])
    patch = 2 * t * d * 3 * cfg["patch_size"] ** 2
    dense = n_layers * 2 * t * (4 * d * d + 2 * d * f)
    attn = (n_layers - n_global) * 4 * t * tok * d + n_global * 4 * t * t * d
    conv_t = 2 * t * (d * d // 2 * 4) + 2 * 4 * t * (d // 2 * d // 4 * 4) + 2 * t * (d * d // 2 * 4)
    grids = [16 * t, 4 * t, t, t // 4]
    convs = sum(2 * px * fpn * (ci + 9 * fpn) for px, ci in zip(grids, (d // 4, d // 2, d, d)))
    by_hand = patch + dense + attn + conv_t + convs
    counted = harness._flops_counter(reference, cell.weight_specs(cfg), cfg)((1008, 1008))
    assert abs(counted / by_hand - 1) < 0.005, (counted, by_hand)
    assert 5.55e12 < by_hand < 5.65e12  # ~5.6 TFLOP an image
