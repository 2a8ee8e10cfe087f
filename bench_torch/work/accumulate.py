"""The fast-BP pixel-tile accumulate (``accumulate_kernel``).

Copied from ``chip_smoke.py::acc_work``: bytes, the band rows (num_p x
rows x 128 complex64), four float32 coefficient planes (num_p x ny), two
float32 per pulse and the (ny x nx) complex64 image, each once; the W-deep
complex MAC of every pixel and pulse (8 W operations) on the tensor cores
as three TF32 passes; the rest in f32: ~20 operations a pixel and pulse for
taper, phase and sum, and a row's split window DFT a pulse (8 W (W / 8 +
9)).

Why three TF32 passes and not one: the configuration states float32, and a
float32-accurate contraction on this card's tensor cores needs the hi x hi,
hi x lo and lo x hi products of the TF32 split; on the f32 FMA pipe the
same contraction's bound is higher (5.42 ms against 2.065 at the
collect's 625 x 1,664 x 640, W 64), so 2.065 ms is the least any
float32-class implementation needs, and PERF.md's bound stands."""


def work(s: dict) -> dict:
    num_p, w, ny, ncols = s["num_p"], s["w"], s["ny"], s["ncols"]
    nx = s.get("nx", ncols)
    return dict(n_bytes=num_p * s["rows"] * 128 * 8.0 + 4 * num_p * ny * 4.0
                + 2 * num_p * 4.0 + ny * nx * 8.0,
                n_flops=num_p * ny * (ncols * 20.0 + 8.0 * w * (w // 8 + 9)),
                n_tc=3.0 * num_p * ny * ncols * 8 * w)
