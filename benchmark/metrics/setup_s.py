"""setup_s: seconds from the process's start to the window's start (torch
and the card, the kernel library, inputs, upload, export, warm-up); host
clock."""


def read(record):
    return record["setup_s"]
