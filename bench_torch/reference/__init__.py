"""Plain PyTorch references: written from the published algorithms (the
upstream scripts' behaviour, as the repo's float64 NumPy oracle describes
it), importing nothing of the port. Each takes ``mode``: 'f64' (the
reference) or 'bf16' (the same arithmetic with every stage's output and
every phase factor rounded to bfloat16 and the stages computed in float32:
the control, one precision below the float32 the configurations state)."""
