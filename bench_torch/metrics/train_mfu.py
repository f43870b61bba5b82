"""train_mfu: Trainer (train/trainer.py train_step, the whole step): model
FLOPs of the window's steps over their time, over 989 TFLOP/s. Moves
train_tok_s."""

import readers


def read(run):
    return readers.train_mfu(run)
