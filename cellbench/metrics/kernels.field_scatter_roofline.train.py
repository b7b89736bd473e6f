"""The field's gradient scatter (K3 for HashBlock, K6 for Hash3DAnchored)
against its least time: the bytes the step's shapes need
(``counts.scatter_bytes``: each sample's gradient row, point and volume
read once, the whole table gradient written once) over the chip's HBM
bandwidth, divided by the device time of the scatter's kernels, by name."""

KERNELS = r"\bk[36]_(keys|hist|scan|scatter|reduce|finish)_kernel"


def read(view):
    c = view.counts
    if view.mode != "train" or not c.get("hbm_bytes_per_s"):
        return None
    ms = view.kernel_device_ms(KERNELS) / view.units["iterations"]
    if ms <= 0:
        return None
    least_ms = c["scatter_bytes"] / c["hbm_bytes_per_s"] * 1e3
    return 100.0 * least_ms / ms
