"""The RDA's RCMC with the azimuth filter (``rcmc_kernel<...>``), one launch
a plane: every Doppler row resampled from its migrated source grid and
multiplied by H.

The function's work, whatever implements it: the (n_az, n_rg) complex64
range-Doppler plane read once and the filtered plane written once (the
source taps of neighbouring cells are neighbouring values, read once), and
H's sin and cos for each cell. ``shapes``: n_az, n_rg. The bound at 7,200 x
13,200: 0.454 ms (bytes, 1.52 GB; the 1.9e8 sin and cos alone 0.045)."""


def work(s: dict) -> dict:
    cells = s["n_az"] * s["n_rg"]
    return dict(n_bytes=2.0 * 8 * cells, n_sfu=2.0 * cells)
