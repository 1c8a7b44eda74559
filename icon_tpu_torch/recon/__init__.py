"""Reconstruction: coarse-to-fine occupancy engine, lattice marching, and
the serving frame (counterparts of ``icon_tpu.recon``)."""
