"""Published peaks of one NVIDIA H100 SXM, and the least time of a count of
operations on it.

NVIDIA's H100 data sheet (SXM): 132 SMs, a boost clock of 1,980 MHz,
3.35 TB/s of HBM3. Per SM and clock (CUDA C++ Programming Guide,
arithmetic instruction throughput, compute capability 9.0; Hopper white
paper): 64 32-bit integer multiply-adds (FMA pipe), 64 other 32-bit
integer operations (ALU pipe) and 128 warp-lane instructions issued in
all (4 schedulers of one 32-lane instruction each). These rates assume
the card's full 700 W; the run prints the card's power limit beside them.
"""

SMS = 132
SM_HZ = 1.98e9
HBM_BYTES_PER_S = 3.35e12
IMAD_PER_SM_CLK = 64
ALU_PER_SM_CLK = 64
ISSUE_PER_SM_CLK = 128


def least_seconds(imad: float, alu: float, fp32: float = 0.0,
                  nbytes: float = 0.0) -> float:
    """The least time for these operation counts and bytes: the longest of
    the pipes that must run them, or of the bytes at the HBM rate."""
    clk = SMS * SM_HZ
    t_ops = max(imad / IMAD_PER_SM_CLK, alu / ALU_PER_SM_CLK,
                (imad + alu + fp32) / ISSUE_PER_SM_CLK) / clk
    return max(t_ops, nbytes / HBM_BYTES_PER_S)


def peaks() -> dict:
    return {"sms": SMS, "sm_mhz": SM_HZ / 1e6,
            "hbm_bytes_per_s": HBM_BYTES_PER_S,
            "per_sm_clk": {"imad": IMAD_PER_SM_CLK, "alu": ALU_PER_SM_CLK,
                           "issue": ISSUE_PER_SM_CLK}}
