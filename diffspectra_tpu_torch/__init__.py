"""DiffSpectra in PyTorch for NVIDIA Hopper: the port of ``diffspectra_tpu``.

Serving path: ``api.Elucidator`` loads a warm-state export, encodes the
spectra with SpecFormer, runs the ancestral reverse diffusion with the DMT
(whose pair-grid attention and coordinate update are the hand-written CUDA
kernels in ``csrc/``), decodes the molecules and ranks them by consensus.
Imports torch, numpy and the standard library only.
"""
