"""FLOP accounting helpers for utilization/MFU reporting.

The port's own copy of `walkai_nos_tpu/utils/flops.py`, with NVIDIA H100
entries ahead of the TPU ones. Peaks are the published dense bf16 numbers
per device; a device kind is matched by substring of its lower-cased name
(`torch.cuda.get_device_name()` on the port, jax's `device_kind` on a
TPU). Unknown device kinds return None: the caller reports MFU as
unavailable rather than guessing.
"""

from __future__ import annotations

# Published peak dense bf16 FLOP/s per chip, by `device_kind` substring.
# Checked in order, so more specific strings come first.
_PEAK_BF16_FLOPS: tuple[tuple[str, float], ...] = (
    ("h100", 989e12),  # H100 SXM, NVIDIA data sheet
    ("v6 lite", 918e12),  # v6e (Trillium)
    ("v6e", 918e12),
    ("v5 lite", 197e12),  # v5e
    ("v5e", 197e12),
    ("v5p", 459e12),
    ("v5", 459e12),
    ("v4", 275e12),
    ("v3", 123e12),
    ("v2", 45e12),
)


# Published HBM bandwidth (bytes/s) per chip, same matching rules.
_HBM_BYTES_PER_S: tuple[tuple[str, float], ...] = (
    ("h100", 3.35e12),  # H100 SXM, NVIDIA data sheet
    ("v6 lite", 1640e9),  # v6e (Trillium)
    ("v6e", 1640e9),
    ("v5 lite", 819e9),  # v5e
    ("v5e", 819e9),
    ("v5p", 2765e9),
    ("v5", 2765e9),
    ("v4", 1228e9),
    ("v3", 900e9),
    ("v2", 700e9),
)


def peak_bf16_flops(device_kind: str) -> float | None:
    """Peak dense bf16 FLOP/s for a device kind string, else None."""
    kind = device_kind.lower()
    for marker, peak in _PEAK_BF16_FLOPS:
        if marker in kind:
            return peak
    return None


def hbm_bytes_per_s(device_kind: str) -> float | None:
    """Published HBM bandwidth for a device kind string, else None."""
    kind = device_kind.lower()
    for marker, bw in _HBM_BYTES_PER_S:
        if marker in kind:
            return bw
    return None


def roofline(
    flops_per_item: float,
    bytes_per_item: float,
    device_kind: str,
) -> dict | None:
    """Roofline characterization of one model pass on one chip.

    arithmetic_intensity (FLOPs/byte) against the chip's ridge point
    (peak / HBM bandwidth) says WHICH wall bounds the pass:
    below the ridge the attainable rate is bandwidth * intensity
    (memory-bound); above it, the bf16 peak (compute-bound — any
    remaining MFU gap is then occupancy/shape-bound, not a memory wall).
    Returns None when the device kind or byte count is unknown.
    """
    peak = peak_bf16_flops(device_kind)
    bw = hbm_bytes_per_s(device_kind)
    if peak is None or bw is None or bytes_per_item <= 0:
        return None
    intensity = flops_per_item / bytes_per_item
    ridge = peak / bw
    attainable = min(peak, bw * intensity)
    return {
        "arithmetic_intensity_flops_per_byte": round(intensity, 2),
        "ridge_flops_per_byte": round(ridge, 2),
        "bound": "memory" if intensity < ridge else "compute",
        "attainable_flops_per_s": attainable,
        "roofline_mfu_ceiling_pct": round(100.0 * attainable / peak, 2),
    }


def vit_flops_per_image(cfg) -> float:
    """Analytic forward-pass FLOPs per image for a ViTConfig.

    Dense matmul FLOPs (2mnk) for patch embedding, attention (qkv/out
    projections + the two T^2 contractions), and the MLP, plus the
    detection heads.
    """
    t = cfg.num_patches + cfg.num_det_tokens
    d = cfg.hidden_dim
    layers = cfg.num_layers
    patch_in = cfg.patch_size * cfg.patch_size * 3
    embed = 2 * cfg.num_patches * patch_in * d
    qkv = 2 * t * d * 3 * d
    attn = 2 * (2 * t * t * d)  # scores + weighted values
    out = 2 * t * d * d
    mlp = 2 * (2 * t * d * cfg.mlp_ratio * d)
    heads = 2 * cfg.num_det_tokens * d * (cfg.num_classes + 4)
    return float(embed + layers * (qkv + attn + out + mlp) + heads)
