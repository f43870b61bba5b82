"""loss_device_ms.train: Trainer (loss): device ms per traced step of the
kernels launched inside train.loss, the f32 cross entropy. Moves
train_tok_s. Read from the program's spans (progtrace.py)."""

import progtrace


def read(run):
    return progtrace.loss_device_ms(run)
