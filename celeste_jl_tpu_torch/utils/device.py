"""The torch.device an entry point runs on."""

import torch


def resolve(device):
    """torch.device(device); raises when it names CUDA and no card is
    present, so a run asked for the card never moves to the CPU quietly."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} was asked for, but "
                           "torch.cuda.is_available() is False")
    return dev
