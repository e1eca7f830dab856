"""Published peaks of the cards the benchmark runs on (NVIDIA H100 SXM data
sheet, dense rates, at the full 700 W power limit), by a piece of the name
``torch.cuda.get_device_name()`` gives."""

from __future__ import annotations

from typing import Optional

PEAKS = {
    "H100": {
        "bf16_flops": 989e12,
        "tf32_flops": 494.7e12,
        "f32_flops": 67e12,
        "bytes": 3.35e12,
    },
}


def peaks(device_kind: str) -> Optional[dict]:
    """The peaks of the card named ``device_kind``, or None for a card the
    table does not hold (a reader then reports nothing)."""
    for key, table in PEAKS.items():
        if key in device_kind:
            return table
    return None
