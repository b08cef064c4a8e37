"""Counter-based random bits (``rng``).  The fused-kernel compiler of the
reference's ``fusion`` package is ported later (ROADMAP.md, Queue 1)."""
