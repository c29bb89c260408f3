"""open_ludwig: a D3Q27 lattice-Boltzmann CFD framework in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of OPEN_Ludwig
(a Julia/CUDA single-GPU solver; see SURVEY.md for the structural map):
regularized-BGK collide-and-stream with WALE LES, equilibrium log-law wall
model, sponge layers, sparse 8^3-cell block storage, 2:1 multi-level grid
refinement with temporal interpolation, Bouzidi interpolated bounce-back,
and surface-stress aerodynamic force integration — all expressed as
functional JAX over static index plans, with the whole multi-level step
schedule compiled into one lax.scan.
"""

__version__ = "0.1.0"
