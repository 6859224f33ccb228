"""The JAX package's counterpart of an op built with the port.

The port carries its own symbolic layer (``Field``, ``Assignment``,
``AutoDiffOp``), so an op built with it cannot be handed to the JAX
package: the JAX lowerings find accesses with ``isinstance(a,
Field.Access)`` against the JAX package's own ``Field`` and would see none.
``jax_twin(op)`` rebuilds the same op from the JAX package's constructors —
the same field names, shapes, layouts and origins, the same assignments,
constant and time-constant fields, diff mode and CSE setting — so the
tests hold the port against the JAX package on equal terms.
"""

from functools import lru_cache

from pystencils_autodiff_tpu import assignment as jassign
from pystencils_autodiff_tpu import autodiff as jautodiff
from pystencils_autodiff_tpu import field as jfield

from pystencils_autodiff_tpu_torch.field import Field

__all__ = ["jax_twin", "jax_field"]


def jax_field(f):
    """The JAX package's ``Field`` declared like the port's ``f``."""
    jf = jfield.Field(f.name, f.spatial_dimensions, index_shape=f.index_shape,
                      dtype=f.dtype, layout=f.layout, origin=f.origin,
                      field_type=jfield.FieldType(f.field_type.value))
    jf.index_major = f.index_major
    return jf


def _expr(e):
    return e.xreplace({a: jfield.Field.Access(jax_field(a.field), a.offsets,
                                              a.index)
                       for a in e.atoms(Field.Access)})


def _assignment(a):
    lhs = _expr(a.lhs) if isinstance(a.lhs, Field.Access) else a.lhs
    return jassign.Assignment(lhs, _expr(a.rhs), a.is_accumulation)


@lru_cache(maxsize=None)
def jax_twin(op):
    """``pystencils_autodiff_tpu.autodiff.AutoDiffOp`` equal to ``op``."""
    coll = op.forward_assignments
    return jautodiff.AutoDiffOp(
        jassign.AssignmentCollection(
            [_assignment(a) for a in coll.main_assignments],
            [_assignment(a) for a in coll.subexpressions]),
        op_name=op.op_name,
        constant_fields=[jax_field(f) for f in op.constant_fields],
        time_constant_fields=[jax_field(f) for f in op.time_constant_fields],
        diff_mode=op.diff_mode.value,
        diff_fields_prefix=op.diff_fields_prefix,
        do_common_subexpression_elimination=op.do_cse)
