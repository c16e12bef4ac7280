"""ZeRO of the port (counterpart of ``deepspeed_tpu/runtime/zero``): so far
the offload of the optimizer state (:mod:`.offload`) and its relay
(:mod:`.relay`), and ZeRO-Infinity's parameter streaming (:mod:`.streaming`,
:mod:`.stream_grad`); stages 1-3 over torch.distributed come later."""
