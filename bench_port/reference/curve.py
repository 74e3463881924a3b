"""Host-side secp256k1 group oracle (pure Python, Jacobian coordinates).

Reference semantics: k256 `ProjectivePoint` / `AffinePoint` (used all over
the Rust reference sources). Points here are immutable `Point` objects holding
Jacobian (X, Y, Z); Z == 0 encodes the identity.

SEC1 compressed encoding matches k256 `to_bytes()` (transcript.rs:7):
33 bytes, 0x02/0x03 prefix by y parity; the identity encodes as 33 zero
bytes (k256 GroupEncoding convention for fixed-width encodings).
"""

from __future__ import annotations

from dataclasses import dataclass

from .field import P, B, GX, GY, fp_add, fp_inv, fp_mul, fp_sqrt, fp_sub


@dataclass(frozen=True)
class Point:
    x: int
    y: int
    z: int

    def is_identity(self) -> bool:
        return self.z == 0

    # -- conversions ---------------------------------------------------

    def to_affine(self) -> tuple[int, int] | None:
        if self.z == 0:
            return None
        zi = fp_inv(self.z)
        zi2 = fp_mul(zi, zi)
        return fp_mul(self.x, zi2), fp_mul(self.y, fp_mul(zi2, zi))

    def to_bytes(self) -> bytes:
        """SEC1 compressed, 33 bytes (identity -> 33 zero bytes)."""
        aff = self.to_affine()
        if aff is None:
            return b"\x00" * 33
        x, y = aff
        return bytes([0x02 + (y & 1)]) + x.to_bytes(32, "big")

    # -- group ops -----------------------------------------------------

    def double(self) -> "Point":
        if self.z == 0 or self.y == 0:
            return IDENTITY
        X, Y, Z = self.x, self.y, self.z
        A = fp_mul(X, X)
        Bb = fp_mul(Y, Y)
        C = fp_mul(Bb, Bb)
        t = fp_add(X, Bb)
        D = fp_sub(fp_sub(fp_mul(t, t), A), C)
        D = fp_add(D, D)
        E = fp_add(fp_add(A, A), A)
        F = fp_mul(E, E)
        X3 = fp_sub(F, fp_add(D, D))
        Y3 = fp_sub(fp_mul(E, fp_sub(D, X3)), 8 * C % P)
        Z3 = fp_mul(fp_add(Y, Y), Z)
        return Point(X3, Y3, Z3)

    def add(self, other: "Point") -> "Point":
        if self.z == 0:
            return other
        if other.z == 0:
            return self
        Z1Z1 = fp_mul(self.z, self.z)
        Z2Z2 = fp_mul(other.z, other.z)
        U1 = fp_mul(self.x, Z2Z2)
        U2 = fp_mul(other.x, Z1Z1)
        S1 = fp_mul(self.y, fp_mul(other.z, Z2Z2))
        S2 = fp_mul(other.y, fp_mul(self.z, Z1Z1))
        H = fp_sub(U2, U1)
        r = fp_sub(S2, S1)
        if H == 0:
            if r == 0:
                return self.double()
            return IDENTITY
        HH = fp_mul(H, H)
        HHH = fp_mul(H, HH)
        V = fp_mul(U1, HH)
        X3 = fp_sub(fp_sub(fp_mul(r, r), HHH), fp_add(V, V))
        Y3 = fp_sub(fp_mul(r, fp_sub(V, X3)), fp_mul(S1, HHH))
        Z3 = fp_mul(fp_mul(self.z, other.z), H)
        return Point(X3, Y3, Z3)

    def neg(self) -> "Point":
        if self.z == 0:
            return self
        return Point(self.x, (-self.y) % P, self.z)

    def mul(self, k: int) -> "Point":
        """Variable-time double-and-add (reference only)."""
        k = k % _N
        acc = IDENTITY
        add = self
        while k:
            if k & 1:
                acc = acc.add(add)
            add = add.double()
            k >>= 1
        return acc

    def eq(self, other: "Point") -> bool:
        """Projective equality (cross-multiplied), as k256 PartialEq."""
        if self.z == 0 or other.z == 0:
            return self.z == other.z
        Z1Z1 = fp_mul(self.z, self.z)
        Z2Z2 = fp_mul(other.z, other.z)
        if fp_mul(self.x, Z2Z2) != fp_mul(other.x, Z1Z1):
            return False
        return fp_mul(self.y, fp_mul(other.z, Z2Z2)) == fp_mul(
            other.y, fp_mul(self.z, Z1Z1)
        )


# N imported lazily to avoid a cycle in docs; value fixed here.
_N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141

IDENTITY = Point(0, 1, 0)
GENERATOR = Point(GX, GY, 1)


def from_affine(x: int, y: int) -> Point:
    return Point(x, y, 1)


def from_bytes(data: bytes) -> Point:
    """Decode SEC1 compressed (33 bytes) or the 33-zero-byte identity."""
    if len(data) != 33:
        raise ValueError("expected 33-byte SEC1 compressed point")
    if data == b"\x00" * 33:
        return IDENTITY
    tag = data[0]
    if tag not in (2, 3):
        raise ValueError("bad SEC1 tag")
    x = int.from_bytes(data[1:], "big")
    if x >= P:
        raise ValueError("x out of range")
    rhs = fp_add(fp_mul(fp_mul(x, x), x), B)
    y = fp_sqrt(rhs)
    if y is None:
        raise ValueError("not a curve point")
    if (y & 1) != (tag & 1):
        y = (-y) % P
    return Point(x, y, 1)


def is_on_curve(pt: Point) -> bool:
    aff = pt.to_affine()
    if aff is None:
        return True
    x, y = aff
    return fp_mul(y, y) == fp_add(fp_mul(fp_mul(x, x), x), B)
