"""Command-line tools (parity with serialize/bin/convert_params.rs); port
of halo2_verifier_tpu/cli.py.

Usage:
    python -m halo2_verifier_tpu_torch.cli convert-params <in.srs> [out]
        Reads an upstream fat SRS (k | n raw G1 | n raw lagrange G1 | raw g2
        | raw s_g2) and writes the 164-byte Processed verifier params
        (default out: <in>.zkverify.srs).
    python -m halo2_verifier_tpu_torch.cli inspect-vk <vk.bin> [--format processed]
        Prints a structural summary of a serialized VerifyingKey.
    python -m halo2_verifier_tpu_torch.cli verify <params> <vk> <proof>
            [--instances f] [--multiopen shplonk|gwc]
            [--hash blake2b|keccak256] [--device cuda|cpu]
        Verifies a proof (instances file: one decimal/hex scalar per line,
        columns separated by blank lines) as a one-proof batch of the
        batch verifier on --device (default cuda: the sqrt pre-pass and
        the forest MSM on the card, the host pairing). Prints OK and exits
        0 for a valid proof, FAIL and 1 for any other proof; exits 2
        without printing a verdict when the device is not available.
"""

from __future__ import annotations

import argparse
import sys


def cmd_convert_params(args):
    from .prover.srs import FullSRS

    with open(args.input, "rb") as f:
        srs = FullSRS.from_bytes(f.read())
    out = args.output or (args.input.rsplit(".", 1)[0] + ".zkverify.srs")
    params = srs.verifier_params()
    with open(out, "wb") as f:
        f.write(params.to_bytes("processed"))
    print(f"wrote verifier params (k={params.k}) to {out} "
          f"({len(params.to_bytes('processed'))} bytes)")


def cmd_inspect_vk(args):
    from .protocol.vk import VerifyingKey

    with open(args.input, "rb") as f:
        vk = VerifyingKey.from_bytes(f.read(), args.format)
    cs = vk.cs
    print(f"k={vk.domain.k} cs_degree={vk.cs_degree} "
          f"transcript_repr={hex(vk.transcript_repr)}")
    print(f"columns: fixed={cs.num_fixed_columns} "
          f"advice={cs.num_advice_columns} instance={cs.num_instance_columns} "
          f"selectors={cs.num_selectors} challenges={cs.num_challenges}")
    print(f"gates={len(cs.gates)} lookups={len(cs.lookups)} "
          f"shuffles={len(cs.shuffles)} coeff_pool={len(cs.coeff_vals)}")
    print(f"queries: advice={len(cs.advice_queries)} "
          f"fixed={len(cs.fixed_queries)} instance={len(cs.instance_queries)}")
    print(f"permutation columns={len(cs.permutation.columns)}")


def _read_instances(path):
    if path is None:
        return [[]]
    columns = [[]]
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                if columns[-1]:
                    columns.append([])
                continue
            columns[-1].append(int(line, 0))
    if not columns[-1] and len(columns) > 1:
        columns.pop()
    return [columns]


def cmd_verify(args):
    from .config import VerifierConfig
    from .protocol.kzg import ParamsKZG, VerifyFailure
    from .protocol.vk import VerifyingKey
    from .utils.device import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    with open(args.params, "rb") as f:
        params = ParamsKZG.from_bytes(f.read(), args.format)
    with open(args.vk, "rb") as f:
        vk = VerifyingKey.from_bytes(f.read(), args.format)
    with open(args.proof, "rb") as f:
        proof = f.read()
    (instances,) = _read_instances(args.instances)
    bv = VerifierConfig(multiopen=args.multiopen,
                        hash=args.hash).make_verifier(params, vk,
                                                      device=device)
    try:
        (res,) = bv.verify_stream([[(proof, instances)]], localize=False)
        ok = res.ok
    except (VerifyFailure, ValueError, EOFError):
        # a malformed proof, as verify_proof_single treats it
        ok = False
    print("OK" if ok else "FAIL")
    return 0 if ok else 1


def main(argv=None):
    ap = argparse.ArgumentParser(prog="halo2_verifier_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p1 = sub.add_parser("convert-params")
    p1.add_argument("input")
    p1.add_argument("output", nargs="?")
    p1.set_defaults(fn=cmd_convert_params)

    p2 = sub.add_parser("inspect-vk")
    p2.add_argument("input")
    p2.add_argument("--format", default="processed")
    p2.set_defaults(fn=cmd_inspect_vk)

    p3 = sub.add_parser("verify")
    p3.add_argument("params")
    p3.add_argument("vk")
    p3.add_argument("proof")
    p3.add_argument("--instances")
    p3.add_argument("--format", default="processed")
    p3.add_argument("--multiopen", default="shplonk",
                    choices=["shplonk", "gwc"])
    p3.add_argument("--hash", default="blake2b",
                    choices=["blake2b", "keccak256"])
    p3.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                    "torch versions of the kernels)")
    p3.set_defaults(fn=cmd_verify)

    args = ap.parse_args(argv)
    return args.fn(args) or 0


if __name__ == "__main__":
    sys.exit(main())
