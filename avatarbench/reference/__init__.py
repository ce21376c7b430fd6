"""The benchmark's plain reference: FLAME with the procedural teeth, the
face frames, the binding chain, the EWA projection and SH colours, a tile
binning and the closed-form front-to-back blend, the L1 + D-SSIM + xyz and
scale losses, and Adam, in plain PyTorch and float32.

It follows the published 3D Gaussian Splatting and GaussianAvatars
equations as the measured program states them, and works every derived
quantity out again from the benchmark's raw inputs (the FLAME arrays, the
Gaussian parameters, the cameras). It imports nothing of the measured
program and nothing of JAX. Matrix products and convolutions run with
TF32 off unless a caller turns it on for the lower-precision control.
"""
