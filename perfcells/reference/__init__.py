"""The plain reference: the same semantics as the traced path, written
independently in plain PyTorch and NumPy.

It imports nothing of `lightpycl_tpu_torch`, `lightpycl_tpu` or `jax`, and
takes nothing the program made: it redraws the source rays from the source
parameters and the seed (`sampling`), finds nearest hits by brute
Moller-Trumbore over every triangle (`nearest_hit`), and follows mirror,
measure and terminator surfaces with power weighting (`trace`), all in the
dtype it is given: float64 for the reference, bfloat16 for the control.
"""
