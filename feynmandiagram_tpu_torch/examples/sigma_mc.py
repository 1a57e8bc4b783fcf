"""End-to-end MC estimate of the two-loop self-energy (BASELINE config 1).

Port of ``examples/sigma_mc.py``: Parquet generation -> optimize -> the
bucketed evaluation of 1e4 Monte-Carlo samples on the card -> crude
importance-free estimator means, then one Monte-Carlo estimation step over
the sample mesh (``parallel.make_mc_step``).  The mesh has one rank in this
process, or spans the processes of ``torch.distributed`` where the
environment configures a group (``utils.initialize_distributed``).

Run:  python -m feynmandiagram_tpu_torch.examples.sigma_mc [--batch N] [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from feynmandiagram_tpu_torch.backends import compile_evaluator
from feynmandiagram_tpu_torch.computational_graph import optimize_inplace
from feynmandiagram_tpu_torch.frontends import ChargeCharge, Instant, NoHartree
from feynmandiagram_tpu_torch.frontends.parquet import DiagPara, Interaction, SigmaDiag, sigma
from feynmandiagram_tpu_torch.ops.dtypes import default_device
from feynmandiagram_tpu_torch.parallel import make_mc_step, make_sample_mesh
from feynmandiagram_tpu_torch.utils import initialize_distributed

KF, BETA, LAM = 1.919, 0.5, 1.0


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=10000)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; 'cpu' on purpose)")
    args = parser.parse_args(argv)
    device = torch.device(args.device) if args.device else default_device()
    para = DiagPara(type=SigmaDiag, innerLoopNum=2, hasTau=True, filter=(NoHartree,),
                    interaction=(Interaction(ChargeCharge, Instant),))
    extK = np.zeros(para.totalLoopNum)
    extK[0] = 1.0
    df = sigma(para, extK, False)
    roots = [row["diagram"] for row in df]
    optimize_inplace(roots)
    compiled = compile_evaluator(roots, max_loop_num=para.totalLoopNum, beta=BETA, kF=KF,
                                 lam=LAM, sum_mode="bucketed", device=device)

    rng = np.random.default_rng(0)
    varK = rng.standard_normal((3, para.totalLoopNum, args.batch)) * KF
    varK[:, 0, :] = np.array([[KF], [0.0], [0.0]])
    varT = rng.random((para.totalTauNum, args.batch)) * BETA

    t0 = time.perf_counter()
    weights = compiled(varK, varT).cpu().numpy()
    dt = time.perf_counter() - t0
    print(f"evaluated {args.batch} samples x {weights.shape[0]} sigma groups on {device} "
          f"in {dt * 1e3:.1f} ms, the first call ({args.batch / dt:,.0f} samples/s)")
    for row, mean in zip(df, weights.mean(axis=1)):
        print(f"  extT={row['extT']}: mean weight {mean:+.6e}")

    # the estimation step over the sample mesh
    initialize_distributed(device=device)
    mesh = make_sample_mesh(device=device)
    means = make_mc_step(compiled, mesh, beta=BETA)(0, 1024).cpu().numpy()
    print(f"mesh({mesh.size} ranks) MC step means: {means[:3]} ...")


if __name__ == "__main__":
    main()
