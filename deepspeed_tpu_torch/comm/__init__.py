"""Communication helpers of the port (counterpart of ``deepspeed_tpu/comm``):
so far the host blockwise int8 codec of :mod:`.quant`."""
