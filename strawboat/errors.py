"""Error types for strawboat.

Mirrors the error surface of the reference (src/errors.rs:18-31): the reference
re-uses arrow2's ``Error`` with ``OutOfSpec`` / ``NotYetImplemented`` variants;
we define native Python exceptions with the same roles.
"""


class StrawboatError(Exception):
    """Base error for strawboat."""


class OutOfSpecError(StrawboatError):
    """The file/bytes violate the format spec (reference: Error::OutOfSpec)."""


class NotYetImplementedError(StrawboatError):
    """Feature not implemented (reference: Error::NotYetImplemented)."""


class CapacityError(StrawboatError):
    """A static capacity (shuffle bin, group slots, join fan-out) overflowed.

    Raised instead of silently dropping/collapsing rows; carries the capacity
    actually required so callers can retry with a larger static size.
    """

    def __init__(self, what: str, capacity: int, required: int):
        super().__init__(
            f"{what} overflow: capacity {capacity} < required {required}"
        )
        self.what = what
        self.capacity = capacity
        self.required = required


def general_err(msg: str, *args) -> OutOfSpecError:
    """Reference: general_err! macro (src/errors.rs:18)."""
    return OutOfSpecError(msg % args if args else msg)
