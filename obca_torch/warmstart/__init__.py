"""Warm starts: lattice planner, Reeds-Shepp paths, velocity profiles
and geometric duals (port of ``obca_tpu.warmstart``)."""
