"""DRIM-X quickstart on PyTorch and one CUDA card (the torch twin of
`examples/quickstart.py`).

    PYTHONPATH=src python examples/quickstart_torch.py   # on the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

Walks the full stack bottom-up:
  1. a DRIM computational sub-array executing AAP microprograms
     (Table 2): single-cycle DRA X(N)OR, TRA MAJ3, the 7-AAP full adder;
  2. the analog sense-amplifier model (Fig. 4-6) agreeing with the
     digital fast path, and failing gracefully under process variation;
  3. throughput/energy one-liners from the Fig. 8 / Fig. 9 models;
  4. the card's hand-written kernels (their plain torch versions on the
     CPU): the sign packer, the XNOR-popcount GEMM that powers BitLinear
     layers, and the bit-plane adder;
  5. the end-to-end front end: write a kernel as a plain Python
     function, `drim_torch.jit` traces it, and one compile -> lower -> run
     pipeline executes it on any engine of the simulated fleet.
"""
import argparse

import numpy as np
import torch

import drim_torch as drim
from repro_torch.core import (DRIM_R, PAPER_TABLE3, cost, dra_analog,
                              drim_latency_s, drim_throughput_bits, encode,
                              load_rows, make_subarray, microprogram_add,
                              microprogram_xnor2, monte_carlo_error_rates,
                              pack_bits, run_program, unpack_bits)
from repro_torch.core.energy import pim_energy_nj_per_kb
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.bitserial_add import bitplane_add_plain
from repro_torch.kernels.packbits import pack_signs_plain


def section(title):
    print(f"\n{'=' * 64}\n{title}\n{'=' * 64}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)

    def bits(x):
        return torch.from_numpy(x.astype(np.int32)).to(dev)

    # ------------------------------------------------------------------
    section("1. DRIM sub-array: AAP microprograms (paper Table 2)")
    row_bits = 256
    a = rng.integers(0, 2, row_bits).astype(np.uint32)
    b = rng.integers(0, 2, row_bits).astype(np.uint32)
    c = rng.integers(0, 2, row_bits).astype(np.uint32)

    sa = make_subarray(n_data=16, row_bits=row_bits, device=dev)
    rows = torch.stack([pack_bits(bits(x)) for x in (a, b, c)])
    sa = load_rows(sa, 0, rows)

    # XNOR2 = 3 AAPs: copy D_i->x1, copy D_j->x2, DRA(x1,x2)->D_r
    prog = microprogram_xnor2(sa, 0, 1, 5)
    n_aaps, _ = cost(prog)
    sa2 = run_program(sa, encode(prog))
    got = unpack_bits(sa2.data[5]).cpu().numpy()
    assert (got == (1 - (a ^ b))).all()
    print(f"XNOR2 of two 256-bit rows in {n_aaps} AAPs "
          f"(Ambit needs 7) -> correct")

    # full adder: Sum via 2xDRA XOR2, Cout via TRA MAJ3 -- 7 AAPs
    prog = microprogram_add(sa, 0, 1, 2, 5, 6)
    n_aaps, _ = cost(prog)
    sa3 = run_program(sa, encode(prog))
    s_got = unpack_bits(sa3.data[5]).cpu().numpy()
    c_got = unpack_bits(sa3.data[6]).cpu().numpy()
    assert (s_got == (a ^ b ^ c)).all()
    assert (c_got == ((a & b) | (a & c) | (b & c))).all()
    print(f"bit-slice full-adder (Sum + Cout) in {n_aaps} AAPs -> correct")

    # ------------------------------------------------------------------
    section("2. Analog sense amplifier (Fig. 4-6, Table 3)")
    xnor_, xor_ = dra_analog(bits(a), bits(b), variation=0.0)
    assert (xnor_.cpu().numpy() == (1 - (a ^ b))).all()
    print("charge-sharing + shifted-VTC inverters == digital XNOR at "
          "0% variation")
    rates = monte_carlo_error_rates(trials=2000, variations=(0.10, 0.30),
                                    seed=0, device=dev)
    for var, r in rates.items():
        p = PAPER_TABLE3[var]
        print(f"  ±{var:.0%} corner: DRA err {r['DRA']:5.2f}% "
              f"(paper {p['DRA']}%)   TRA err {r['TRA']:5.2f}% "
              f"(paper {p['TRA']}%)")

    # ------------------------------------------------------------------
    section("3. Throughput / energy models (Fig. 8 / Fig. 9)")
    for op in ("not", "xnor2", "add"):
        tput = drim_throughput_bits(DRIM_R, op) / 1e9
        lat = drim_latency_s(DRIM_R, op, 2**27) * 1e6
        e = pim_energy_nj_per_kb("DRIM", op)
        print(f"  {op:>6}: {tput:8.1f} Gbit/s   2^27-bit vector in "
              f"{lat:7.1f} us   {e:5.2f} nJ/KB")

    # ------------------------------------------------------------------
    section("4. The card's CUDA kernels (their plain versions on the CPU)")
    x = torch.from_numpy(rng.standard_normal((8, 512)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((512, 256)).astype(np.float32))
    xp = ops.pack_signs(x.to(dev))
    wp = ops.pack_signs(w.T.contiguous().to(dev))
    assert torch.equal(xp.cpu(), pack_signs_plain(x))
    assert torch.equal(wp.cpu(), pack_signs_plain(w.T.contiguous()))
    print(f"sign-packed activations {tuple(x.shape)} -> {tuple(xp.shape)} "
          f"int32 words (32x smaller) == the plain packer")
    got = ops.xnor_gemm_packed(xp, wp, k_bits=512)
    want = torch.sign(x) @ torch.sign(w)
    assert torch.equal(got.cpu().to(torch.float32), want)
    print("XNOR-popcount GEMM == sign(x) @ sign(w)  (the BitLinear core)")

    # 4-bit integers in bit-plane layout: plane i holds bit i of each lane
    nbits, lanes = 4, 1024
    ia = rng.integers(0, 1 << nbits, lanes)
    ib = rng.integers(0, 1 << nbits, lanes)
    planes_a, planes_b = (
        torch.stack([pack_bits(bits((v >> i) & 1)) for i in range(nbits)])
        for v in (ia, ib))
    ssum, carry = ops.bitplane_add(planes_a, planes_b)
    plain_sum, plain_carry = bitplane_add_plain(planes_a.cpu(),
                                                planes_b.cpu())
    assert torch.equal(ssum.cpu(), plain_sum)
    assert torch.equal(carry.cpu(), plain_carry)
    total = sum(unpack_bits(ssum[i]).cpu().numpy().astype(np.int64) << i
                for i in range(nbits))
    total += unpack_bits(carry).cpu().numpy().astype(np.int64) << nbits
    assert (total == ia + ib).all()
    print(f"bit-plane ripple adder over {nbits}-bit planes -> sum "
          f"{tuple(ssum.shape)}, carry-out {tuple(carry.shape)} == a + b "
          f"(paper's MAJ3+2xXOR2 decomposition)")

    # ------------------------------------------------------------------
    section("5. drim_torch.jit: a kernel in plain Python, one pipeline")

    @drim.jit
    def kernel(a_, b_, c_):
        x_ = drim.xnor(a_, b_)               # single-cycle DRA
        s_, carry_ = drim.full_add(x_, c_, b_)
        return {"s": s_, "carry": carry_}

    words = rng.integers(0, 1 << 32, (3, 64), dtype=np.uint32)
    out = kernel(*words, device=dev)         # trace->compile->lower->run
    x_np = ~(words[0] ^ words[1])
    assert (out["s"].cpu().numpy().view(np.uint32)
            == (x_np ^ words[2] ^ words[1])).all()
    sched = kernel.last_schedule
    print(f"traced kernel: {kernel.trace().n_nodes} nodes fused into "
          f"{sched.aaps_per_tile} AAPs/tile over {sched.waves} wave(s)")

    low = drim.compile(kernel).lower(engine="queued")
    low.run(*words, device=dev)
    v = low.verdict(2 ** 27)
    print(f"same trace on engine='queued': "
          f"{type(low.schedule).__name__}, 2^27-bit verdict -> "
          f"{v.winner} ({', '.join(r.contender for r in v.rows)})")

    print("\nQuickstart complete. Next: examples/train_bnn_lm_torch.py")


if __name__ == "__main__":
    main()
