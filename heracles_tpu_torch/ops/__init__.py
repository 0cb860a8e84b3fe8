"""Kernel-backed operations of the port: the SHT, the Gram contraction
of the mixing matrices and the FMA-peak probe."""
