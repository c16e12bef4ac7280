"""fp16 mixed precision: the dynamic loss scaler."""
