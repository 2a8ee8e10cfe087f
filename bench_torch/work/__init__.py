"""The work of each hand-written kernel's function, from its shapes: one
module per kernel, each with ``work(shapes) -> dict`` of ``n_bytes``,
``n_flops`` (f32), ``n_sfu`` (sin and cos results) and ``n_tc`` (TF32
tensor-core operations) for one launch. Bytes count each input once and
each output once; the work is the function's, not an implementation's, so a
later kernel for the same function is read against the same work."""
