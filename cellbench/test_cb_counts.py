"""The yardstick's counts depend on the configuration's shapes alone.
CPU only."""

from __future__ import annotations

from cellbench import counts, manifest


def cfg(name):
    return manifest.config(name)["config"]


def test_sample_flops_from_widths():
    # encode 16 levels x 8 corners x (2 + 2 x 2); field MLP 32-64-64-16;
    # shader MLP 32-64-64-64-3
    want = 16 * 8 * 6 + 2 * (32 * 64 + 64 * 64 + 64 * 16) \
        + 2 * (32 * 64 + 64 * 64 + 64 * 64 + 64 * 3)
    assert counts.sample_flops(cfg("wanjinyou-hashblock")) == want
    assert counts.sample_flops(cfg("wanjinyou-anchored")) == want


def test_scatter_bytes_from_shapes():
    hb, an = cfg("wanjinyou-hashblock"), cfg("wanjinyou-anchored")
    assert counts.field_gradient_bytes(hb) == 16 * 16384 * 128 * 4
    assert counts.field_gradient_bytes(an) == 16 * 524288 * 2 * 4
    for c in (hb, an):
        base = counts.scatter_bytes(c, 0)
        assert base == counts.field_gradient_bytes(c)
        assert counts.scatter_bytes(c, 278528) - base == 278528 * (128 + 12 + 4)


def test_peak_is_known_for_the_card_only():
    assert counts.peak("NVIDIA H100 80GB HBM3") == dict(f32_flops=67e12,
                                                      hbm_bytes_per_s=3.35e12)
    assert counts.peak("cpu") is None
