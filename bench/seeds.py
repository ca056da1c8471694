"""Sub-seeds drawn from the run's --seed (any whole number) and a path of
keys: every input of a run is made from one of these, so the same seed
gives the same inputs in every process and in the reference."""
from __future__ import annotations

import hashlib


def derive(seed: int, *keys) -> int:
    """A 63-bit seed for a torch.Generator from `seed` and `keys`."""
    text = "/".join(str(k) for k in (seed,) + keys)
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8],
                          "little") >> 1


def generator(device, seed: int, *keys):
    import torch
    return torch.Generator(device=device).manual_seed(derive(seed, *keys))


def sample_index(seed: int, key, numel: int, size: int, device):
    """`size` element indices of a tensor of `numel` elements drawn from
    (seed, key), or every index where it has no more."""
    import torch
    if numel <= size:
        return torch.arange(numel, device=device)
    return torch.randint(0, numel, (size,), device=device,
                         generator=generator(device, seed, "element", key))
