"""Interior-point solver, KKT dispatch and block-tridiagonal linear
algebra (port of ``obca_tpu.solver``)."""
