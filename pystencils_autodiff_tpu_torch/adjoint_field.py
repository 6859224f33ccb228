"""Adjoint fields: the \\hat{f} companions of primal fields (a copy of
``pystencils_autodiff_tpu/adjoint_field.py`` over the port's own ``Field``).

Parity with the reference's ``adjoint_field.py`` (SURVEY.md §2.1 #3): an
``AdjointField`` is a Field named ``diff_prefix + primal.name`` that renders
as ``\\hat{f}`` in LaTeX and keeps a link to its primal via
``corresponding_forward_field``.
"""

from __future__ import annotations

from .field import Field

__all__ = ["AdjointField"]

DEFAULT_DIFF_PREFIX = "diff"


class AdjointField(Field):
    """Field holding the adjoint (reverse-mode gradient) of a primal field.

    Same spatial/index structure, dtype, layout and staggering origin as the
    primal; only the name differs.
    """

    def __init__(self, forward_field: Field, diff_prefix: str = DEFAULT_DIFF_PREFIX):
        super().__init__(
            name=diff_prefix + forward_field.name,
            spatial_dimensions=forward_field.spatial_dimensions,
            index_shape=forward_field.index_shape,
            dtype=forward_field.dtype,
            layout=forward_field.layout,
            origin=forward_field.origin,
            field_type=forward_field.field_type,
        )
        # layout above is the spatial permutation only; the index-dim
        # placement (SoA) must carry over too so gradients come back in the
        # primal's storage layout
        self.index_major = getattr(forward_field, "index_major", False)
        self.corresponding_forward_field = forward_field
        self.diff_prefix = diff_prefix
        self.latex_name = r"\hat{%s}" % forward_field.name

    def __repr__(self):
        return f"AdjointField({self.corresponding_forward_field.name!r} → {self.name!r})"
