"""decode_host_ms.batch: Decode step: mean host time of a decode step that ran
the model (its span less its waits on the device), over the window's steps.
Moves output_tok_s. Read from the program's spans (progtrace.py)."""

import progtrace


def read(run):
    return progtrace.decode_host_ms(run)
