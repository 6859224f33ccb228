"""A torch training loop on the stencil op through the generated native
operators, then the same in TensorFlow with the compiled native op, where
TensorFlow is installed (the port of ``examples/torch_tf_interop.py``).

    python examples/torch_port/torch_tf_interop.py [--device cpu] [--steps N]

``create_pytorch_op(backend="torch_native")`` runs CUDA tensors through
the window kernel (one launch forward, one backward) and CPU tensors
through the op's generated C kernels registered as PyTorch operators.
The TensorFlow op runs the generated C kernels on the CPU."""

import numpy as np
import torch

from port_cli import parse, parser

from pystencils_autodiff_tpu_torch import Assignment, AutoDiffOp, fields

N, STEPS, LR = 24, 300, 0.05


def make_op():
    u, out, k = fields("u, out, k", 2)
    return AutoDiffOp([Assignment(out.center, u[0, 0] + 0.1 * k[0, 0] * (
        u[1, 0] + u[-1, 0] + u[0, 1] + u[0, -1] - 4 * u[0, 0]))],
        op_name="demo_heat")


def single_steps():
    """(op, spatial shape, float type, periodic, differentiated) of every
    single step this example launches: a card run may build their
    libraries before it starts."""
    return [(make_op(), (N, N), dtype, False, True)
            for dtype in (torch.float64, torch.float32)]


def inputs(n=N):
    """(u0, k_true) in float64 on the CPU, from numpy's seeded generator."""
    rng = np.random.default_rng(0)
    u0 = torch.tensor(rng.standard_normal((n, n)))
    k_true = torch.tensor(1.0 + 0.5 / (1 + np.exp(-rng.standard_normal(
        (n, n)))))
    return u0, k_true


def train_torch(apply, u0, k_true, steps=STEPS, lr=LR):
    """Adam on κ from ones against ``apply(k_true, u0)``: (last loss,
    target, κ)."""
    with torch.no_grad():
        target = apply(k_true, u0)
    k_hat = torch.ones_like(u0, requires_grad=True)
    opt = torch.optim.Adam([k_hat], lr=lr)
    for _ in range(steps):
        opt.zero_grad()
        loss = (apply(k_hat, u0) - target).pow(2).mean()
        loss.backward()
        opt.step()
    return loss.item(), target, k_hat.detach()


def train_tf(op, u0, target, steps=STEPS, lr=LR):
    """The same loop in TensorFlow through the compiled native op: (last
    loss, κ) as numpy."""
    import tensorflow as tf

    tf_fn = op.create_tensorflow_op(backend="tensorflow_native")
    print("tf op inputs:", tf_fn.input_names)
    k_var = tf.Variable(np.ones(tuple(u0.shape)))
    u_const = tf.constant(u0.cpu().numpy())
    tgt = tf.constant(target.cpu().numpy())
    opt = tf.keras.optimizers.Adam(lr)
    for _ in range(steps):
        with tf.GradientTape() as tape:
            loss = tf.reduce_mean((tf_fn(k_var, u_const) - tgt) ** 2)
        g = tape.gradient(loss, [k_var])
        opt.apply_gradients(zip(g, [k_var]))
    return float(loss), k_var.numpy()


def tensorflow_missing():
    """Why TensorFlow cannot run here, or None."""
    try:
        import tensorflow  # noqa: F401
    except ImportError as e:
        return str(e)
    return None


def main(argv=None):
    ap = parser(__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=STEPS,
                    help=f"Adam steps of each loop (default {STEPS})")
    args, dev = parse(ap, argv)
    full = args.steps >= STEPS
    op = make_op()
    apply = op.create_pytorch_op(backend="torch_native")
    print("torch op inputs:", apply.input_names)
    u0, k_true = (t.to(dev) for t in inputs())
    loss, target, k_hat = train_torch(apply, u0, k_true, args.steps)
    print(f"torch-native final loss: {loss:.3e}")
    assert loss < (1e-10 if full else 1.0)
    print("TORCH NATIVE OK")
    why = tensorflow_missing()
    if why is not None:
        print(f"the TensorFlow half did not run: TensorFlow is not "
              f"installed here ({why})")
    else:
        loss_tf, k_tf = train_tf(op, u0, target, args.steps)
        print(f"tf-native final loss: {loss_tf:.3e}")
        assert loss_tf < (1e-9 if full else 1.0)
        # torch and tf recovered the same κ
        dk = np.abs(k_hat.cpu().numpy() - k_tf).max()
        print(f"max |kappa_torch - kappa_tf| = {dk:.2e}")
        print("TF NATIVE OK")
    apply32 = op.create_pytorch_op(backend="torch_native",
                                   dtype=torch.float32)
    o32 = apply32(k_true.float().requires_grad_(True), u0.float())
    o32.sum().backward()
    print("f32 native ok:", o32.dtype)
    assert o32.dtype == torch.float32
    return {"loss": loss}


if __name__ == "__main__":
    main()
