"""Train the paper-app BNN LM on PyTorch and one CUDA card (the torch twin
of `examples/train_bnn_lm.py`).

    PYTHONPATH=src python examples/train_bnn_lm_torch.py          # ~100M
    PYTHONPATH=src python examples/train_bnn_lm_torch.py --quick    # CI scale
    PYTHONPATH=src python examples/train_bnn_lm_torch.py --quick --device cpu

drim-bnn is the paper's own application class: an LM whose FFN matmuls
are BitLinear -- sign-binarized weights/activations multiplied with the
XNOR-popcount identity (straight-through estimator for gradients), the
bulk bit-wise X(N)OR workload DRIM accelerates.

The run exercises the port's training path: config -> synthetic data
pipeline -> train step (AdamW, cosine schedule; flash attention's
forward and backward kernels on the card) -> checkpoint every 50 steps
-> restart-capable, under `--mesh host` (the host mesh and the state's
ZeRO-1 shardings), as the reference's example runs.  Loss on the
synthetic Zipf-LM task should fall from ~ln(V)=10.4 to <7 within 300
steps.  Extra flags pass through to `repro_torch.launch.train` (the last
of a repeated flag wins).
"""
import argparse
import sys
import tempfile

from repro_torch.launch import train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="reduced config + 30 steps (CI scale)")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--compress", action="store_true",
                    help="1-bit error-feedback gradient all-reduce")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args, extra = ap.parse_known_args(argv)

    ckpt_dir = tempfile.mkdtemp(prefix="drim_bnn_ckpt_")
    steps = args.steps or (30 if args.quick else 300)
    argv = ["--arch", "drim-bnn", "--steps", str(steps),
            "--batch", "8", "--seq", "256", "--mesh", "host",
            "--lr", "3e-4", "--ckpt-dir", ckpt_dir,
            "--ckpt-every", "50", "--log-every", "10"]
    if args.quick:
        argv.append("--smoke-config")
    if args.compress:
        argv.append("--compress")
    if args.device is not None:
        argv += ["--device", args.device]
    argv += extra

    print(f"training drim-bnn ({'smoke' if args.quick else '~100M'}) "
          f"for {steps} steps; checkpoints -> {ckpt_dir}")
    final_loss = train.main(argv)
    print(f"final loss {final_loss:.4f}  (checkpoints kept in {ckpt_dir};"
          f" resume with --resume)")
    return 0 if final_loss == final_loss else 1  # NaN guard


if __name__ == "__main__":
    sys.exit(main())
