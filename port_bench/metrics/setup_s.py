"""Seconds from the start of the process to the start of the window:
imports, the card, the kernel library, data, model, state and warm-up."""


def read(obs):
    return obs.setup_s
