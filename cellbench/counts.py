"""The yardstick's arithmetic: the chip's peaks, a sample's model FLOPs
from the configuration's widths, and the field scatter's least bytes from
the step's shapes. None of it depends on how the program computes."""

from __future__ import annotations

from .reference import hash_block, hash_encoding

# published peaks (NVIDIA's data sheet, H100 SXM5, dense, at the 700 W
# limit): float32 outside the tensor cores and HBM3 bandwidth. The program
# multiplies bfloat16-rounded inputs in float32 with TF32 off, so float32
# is the peak its products run against.
PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(f32_flops=67e12, hbm_bytes_per_s=3.35e12),
}
CORNERS = 8


def peak(device_name: str) -> dict | None:
    return PEAKS.get(device_name)


def mlp_flops(d_in: int, d_out: int, d_hidden: int, n_hidden: int) -> int:
    """Multiply-adds times 2 of a bias-free MLP with ``n_hidden`` + 1
    hidden widths, as the configuration's MLPs are built."""
    dims = [d_in] + [d_hidden] * (n_hidden + 1) + [d_out]
    return 2 * sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def sample_flops(cfg: dict) -> int:
    """Model FLOPs of one sample's forward: the encode's interpolation
    (each level's 8 corner weights, 2 products each, and 2 channels
    multiplied and added a corner), the field MLP and the shader MLP."""
    f, s = cfg["field"], cfg["shader"]
    levels, ch = hash_encoding.N_LEVELS, hash_encoding.N_CHANNELS
    encode = levels * CORNERS * (2 + 2 * ch)
    field = mlp_flops(levels * ch, int(f["mlp_out_dim"]), int(f["mlp_hidden_dim"]),
                      int(f["n_hidden_layers"]))
    shader = mlp_flops(int(s["d_in"]), int(s["d_out"]), int(s["d_hidden"]),
                       int(s["n_hiddens"]))
    return encode + field + shader


def field_gradient_bytes(cfg: dict) -> int:
    """Bytes of the field's whole table gradient: HashBlock [16, nb, 128]
    f32, Hash3DAnchored [16 * local size, 2] f32."""
    f = cfg["field"]
    l2t = int(f["log2_table_size"])
    if f.get("type", "HashBlock") == "HashBlock":
        return hash_encoding.N_LEVELS * hash_block.n_blocks(l2t) * hash_block.LANES * 4
    return hash_encoding.N_LEVELS * hash_encoding.local_size(l2t) * hash_encoding.N_CHANNELS * 4


def scatter_bytes(cfg: dict, n_samples: int) -> int:
    """The field scatter's least traffic for ``n_samples`` samples: each
    sample's gradient row (32 f32), point (3 f32) and volume (i32) read
    once, the whole table gradient written once (the scatter stores every
    row or entry, those no sample touches as zeros)."""
    per_sample = hash_encoding.N_LEVELS * hash_encoding.N_CHANNELS * 4 + 3 * 4 + 4
    return n_samples * per_sample + field_gradient_bytes(cfg)
