"""Host-only tools of HAST, copied from hast_tpu/tools without jax."""
