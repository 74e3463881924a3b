"""The one generator of traffic: every cell's inputs follow from its
workload file's parameters and the run's `--seed`.

Host-side draws come from numpy generators keyed by (seed, purpose), so
one seed gives the same inputs in every run and two purposes never share a
stream; bulk per-lane data is drawn on the device by `device_scalars`.
"""

from __future__ import annotations

import zlib

import numpy as np

# the 7 ways a verify cell spoils a proof (one lane of each in every block
# of `per_lanes`); `apply_tamper` says what each does to the wire bytes
TAMPER_KINDS = ("poles_point_byte", "final_scalar", "wrong_commitment", "bad_tag",
                "scalar_ge_n", "round_point_byte", "x_ge_p")
N_INT = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141


def rng(seed: int, purpose: str) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 64), zlib.crc32(purpose.encode())])


def seed_string(config: str, seed: int) -> str:
    """The seed of a configuration's public generators (`reference.instances`)."""
    return f"bench_port {config} {int(seed)}"


def u64_values(seed: int, distinct: int, fixed) -> list:
    """`distinct` u64 values: the workload's `fixed` ones first, then
    uniform draws."""
    fixed = [int(v) for v in fixed][:distinct]
    r = rng(seed, "u64 values")
    extra = r.integers(0, 1 << 63, size=(distinct - len(fixed), 2), dtype=np.int64)
    return fixed + [int(a) << 1 | int(b) & 1 for a, b in extra]


def tamper_plan(seed: int, B: int, per_lanes: int) -> list:
    """[(lane, kind)]: in every whole block of `per_lanes` lanes one lane
    of each kind, at positions and in an order drawn from the seed."""
    r = rng(seed, "tamper")
    out = []
    for base in range(0, B - per_lanes + 1, per_lanes):
        pos = r.choice(per_lanes, size=len(TAMPER_KINDS), replace=False)
        order = r.permutation(len(TAMPER_KINDS))
        out += [(base + int(p), TAMPER_KINDS[int(k)]) for p, k in zip(pos, order)]
    return sorted(out)


def apply_tamper(arrs: dict, lane: int, kind: str, distinct: int, orig: dict) -> None:
    """Spoil lane `lane` of wire arrays (numpy, batch axis last) in place;
    `orig` holds the arrays before any lane was spoiled."""
    if kind == "poles_point_byte":
        arrs["r"][5, lane] ^= 0x40
    elif kind == "final_scalar":
        arrs["wnla_l"][0, 0, lane] = (arrs["wnla_l"][0, 0, lane] + 1) % (1 << 16)
    elif kind == "wrong_commitment":  # the commitment of the next distinct proof
        arrs["com"][:, lane] = orig["com"][:, (lane + 1) % distinct]
    elif kind == "bad_tag":
        arrs["c_s"][0, lane] = 7
    elif kind == "scalar_ge_n":
        bad = N_INT + 5
        arrs["wnla_n"][:, 0, lane] = [(bad >> (16 * i)) & 0xFFFF for i in range(16)]
    elif kind == "round_point_byte":
        arrs["wnla_x"][3, 2 % arrs["wnla_x"].shape[1], lane] ^= 0x11
    elif kind == "x_ge_p":
        arrs["r"][1:, lane] = 0xFF
        arrs["r"][0, lane] = 2
    else:
        raise ValueError(f"unknown tamper kind {kind!r}")


def sample_lanes(seed: int, B: int, n: int, fixed=()) -> list:
    """`fixed` lanes and then distinct lanes drawn from the seed, n in all."""
    fixed = [int(b) for b in fixed if 0 <= int(b) < B]
    rest = [b for b in rng(seed, "sample").permutation(B).tolist() if b not in fixed]
    return sorted(fixed + rest[: max(0, n - len(fixed))])


def poisson_arrivals(seed: int, rate_per_s: float, seconds: float,
                     purpose: str = "arrivals") -> np.ndarray:
    """Arrival times (seconds from the window's start) of a Poisson stream."""
    r = rng(seed, purpose)
    n = int(rate_per_s * seconds * 1.2) + 64
    t = np.cumsum(r.exponential(1.0 / rate_per_s, size=n))
    while t[-1] < seconds:
        t = np.concatenate([t, t[-1] + np.cumsum(r.exponential(1.0 / rate_per_s, size=n))])
    return t[t < seconds]


def device_scalars(gen, shape, device):
    """Uniform-looking scalars below n as int64 16-bit limbs, shape
    (16, *shape), drawn on `device` by the torch generator `gen` in one
    call: the top limb is drawn below 0xFFFF, so every value is below n."""
    import torch

    limbs = torch.randint(0, 1 << 16, (16,) + tuple(shape), generator=gen, device=device,
                          dtype=torch.int64)
    limbs[15] %= 0xFFFF
    return limbs


def torch_generator(seed: int, device, purpose: str):
    import torch

    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + zlib.crc32(purpose.encode())) % (1 << 63))
    return g
