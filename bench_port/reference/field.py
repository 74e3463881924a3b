"""Host-side secp256k1 field oracle (pure Python ints).

The slow-but-obviously-correct reference the benchmark holds the
port's limb arithmetic against. Mirrors the behaviour of the k256 crate's base
field F_p and scalar field F_n (reference: k256 v0.13.3, used by
the Rust reference sources via Cargo.toml:16).

All values are plain Python ints in [0, modulus).
"""

# Base field prime: p = 2^256 - 2^32 - 977
P = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F
# Scalar field (group order)
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141

# Curve: y^2 = x^3 + 7 over F_p
B = 7

# Generator (SEC2 standard)
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8


def fp_add(a: int, b: int) -> int:
    return (a + b) % P


def fp_sub(a: int, b: int) -> int:
    return (a - b) % P


def fp_mul(a: int, b: int) -> int:
    return (a * b) % P


def fp_inv(a: int) -> int:
    if a % P == 0:
        raise ZeroDivisionError("inversion of zero in F_p")
    return pow(a, P - 2, P)


def fp_sqrt(a: int) -> int | None:
    """Square root in F_p (p = 3 mod 4). Returns None if non-residue."""
    r = pow(a, (P + 1) // 4, P)
    if (r * r) % P != a % P:
        return None
    return r


def fn_add(a: int, b: int) -> int:
    return (a + b) % N


def fn_sub(a: int, b: int) -> int:
    return (a - b) % N


def fn_mul(a: int, b: int) -> int:
    return (a * b) % N


def fn_neg(a: int) -> int:
    return (-a) % N


def fn_inv(a: int) -> int:
    if a % N == 0:
        raise ZeroDivisionError("inversion of zero in F_n")
    return pow(a, N - 2, N)


def fn_pow(a: int, e: int) -> int:
    return pow(a, e, N)


def scalar_from_be_bytes(b: bytes) -> int:
    """k256 `Scalar::from_repr` semantics: 32 big-endian bytes, must be
    canonical (< N). Reference unwraps (transcript.rs:13) — probability of
    a non-canonical challenge is ~2^-128, treated as unreachable."""
    v = int.from_bytes(b, "big")
    if v >= N:
        raise ValueError("non-canonical scalar (>= group order)")
    return v


def scalar_to_be_bytes(v: int) -> bytes:
    return int(v % N).to_bytes(32, "big")


def scalar_from_wide_bytes(b: bytes) -> int:
    """k256 `Scalar::generate_biased`-style reduction of wide randomness.

    k256 samples a `WideScalar` (64 bytes) and reduces mod N
    (circuit.rs:264-298 uses this for every blinding lane). For fixture
    reproduction we mirror that shape: 64 big-endian bytes reduced mod N.
    """
    assert len(b) == 64
    return int.from_bytes(b, "big") % N
