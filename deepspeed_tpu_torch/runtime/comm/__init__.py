"""Quantized collectives of the runtime (counterpart of
``deepspeed_tpu/runtime/comm``): the block codec and the two ZeRO++
collectives of :mod:`.quantized`."""
