"""Diagnostic tools of the port (counterparts of the root `tools/`):
`parity_vs_reference` (asset checks, render and gradient dumps in the
reference's exchange format, dump comparison, the kernels-against-plain
self check) and `diag_eval_views` (per-view PSNR of a recovery run). Run
each with `python -m gaussianavatars_torch.tools.<name>`."""
