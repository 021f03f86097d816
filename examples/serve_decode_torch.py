"""Batched serving on PyTorch and one CUDA card (the torch twin of
`examples/serve_decode.py`): prefill a prompt batch, decode greedily.

    PYTHONPATH=src python examples/serve_decode_torch.py   # on the card
    PYTHONPATH=src python examples/serve_decode_torch.py --engine resident
    PYTHONPATH=src python examples/serve_decode_torch.py --device cpu

Drives the port's serving path (static-shape KV caches, prefill + decode
steps, batched sampling) on the drim-bnn smoke config.  Extra flags pass
through to `repro_torch.launch.serve`: `--engine
{gpu,resident,baseline,queued,cuda}` routes BitLinear decode matmuls
through the carry-save pipeline on the simulated DRIM fleet (greedy
token ids stay identical to the native "gpu" path), `--packed` serves
from bit-packed weights with a bit-exactness assert, and `--microbench`
/ `--continuous N` select the prefill/insert/generate split and the
continuous-batching wave scheduler.  It serves under `--mesh host`, as
the reference's example does: the host mesh over the serving devices.
"""
import argparse

from repro_torch.launch import serve


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="drim-bnn")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args, extra = ap.parse_known_args(argv)

    argv = ["--arch", args.arch, "--smoke-config",
            "--batch", str(args.batch),
            "--prompt-len", str(args.prompt_len),
            "--gen", str(args.gen), "--mesh", "host"] + extra
    if args.device is not None:
        argv += ["--device", args.device]
    serve.main(argv)


if __name__ == "__main__":
    main()
