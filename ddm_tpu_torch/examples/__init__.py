"""Example drivers of the port (counterparts of ``ddm_tpu/examples``)."""
