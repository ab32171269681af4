"""`runmat_tpu_torch/sass.py` on machine code written here: the loop it
finds, the bytes an iteration stores, the bound that follows, and the
refusal of a loop whose static count need not be what runs. (On the card, `chip_smoke.py` and `rngbench.py`
read the built kernels with it.)"""

import pytest

from runmat_tpu_torch import sass

# a kernel with a loop from 0x0080 to 0x0200 that holds a store guarded by
# a branch, and a tail after the loop; its odd variant; and a kernel shaped
# like libm's, whose loop holds a slow path behind a forward branch (a call
# and a local-memory frame)
LISTING = """
        Function : _ZN4demo6kernelILb1EEEvPf
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   S2R R0, SR_TID.X ;
        /*0080*/                   IADD3 R2, R2, R3, RZ ;
        /*0090*/                   SHF.L.W.U32.HI R3, R3, 0xd, R3 ;
        /*00a0*/                   LOP3.LUT R3, R3, R2, RZ, 0x3c, !PT ;
        /*00b0*/                   FFMA R4, R2, R5, 1 ;
        /*0110*/                   MUFU.RSQ R6, R4 ;
        /*0120*/                   DFMA R8, R8, R8, R8 ;
        /*0130*/                   STG.E.64 desc[UR4][R10.64], R6 ;
        /*0140*/                @P1 BRA 0x160 ;
        /*0150*/                   STG.E desc[UR4][R12.64], R6 ;
        /*0160*/                   ISETP.GE.AND P2, PT, R2, R7, PT ;
        /*0200*/               @!P2 BRA 0x80 ;
        /*0210*/                   EXIT ;
        /*0300*/                   RET.REL.NODEC R4 0x0 ;
        Function : _ZN4demo6kernelILb0EEEvPf
        /*0000*/                   STG.E.128 desc[UR4][R10.64], R4 ;
        /*0010*/               @!P2 BRA 0x0 ;
        Function : _ZN4demo4slowEPf
        /*0000*/                   FFMA R4, R2, R5, 1 ;
        /*0010*/               @!P0 BRA 0x50 ;
        /*0020*/                   STL [R1], R4 ;
        /*0030*/                   CALL.REL.NOINC 0x100 ;
        /*0040*/                   LDL R4, [R1] ;
        /*0050*/                   STG.E desc[UR4][R12.64], R4 ;
        /*0060*/               @!P2 BRA 0x0 ;
        /*0070*/                   EXIT ;
        /*0100*/                   RET.REL.NODEC R4 0x0 ;
"""


def _mixes():
    return {k: sass.mix(sass.main_loop(v))
            for k, v in sass.kernels(LISTING).items()}


def test_loop_mix():
    insns = sass.kernels(LISTING)["_ZN4demo6kernelILb1EEEvPf"]
    loop = sass.main_loop(insns)
    assert loop[0][0] == 0x80 and loop[-1][0] == 0x200
    m = sass.mix(loop)
    assert m["instructions"] == 11 and m["calls_or_local"] == 0
    assert (m["alu"], m["fma"], m["fp64"], m["mufu"]) == (4, 1, 1, 1)
    assert (m["memory"], m["other"]) == (2, 2)
    # the guarded store runs in some iterations: it counts
    assert m["store_bytes"] == 12
    # 11 issue slots against 4 ALU x 2 and 1 MUFU x 8
    assert m["loop_cycles"] == 11


def test_loop_with_a_call_has_no_bound():
    m = _mixes()["_ZN4demo4slowEPf"]
    assert m["instructions"] == 7 and m["calls_or_local"] == 3
    with pytest.raises(ValueError, match="no bound"):
        sass.warp_cycles(m, 10 ** 6, 4)


def test_bound_from_the_loop():
    name, m = sass.find(_mixes(), "kernel", even=True)
    assert name == "_ZN4demo6kernelILb1EEEvPf"
    assert sass.find(_mixes(), "kernel", even=False)[1]["store_bytes"] == 16
    # 3 * 10^6 floats of 4 bytes at 12 bytes an iteration: 10^6 thread
    # iterations, 31250 warp iterations of 11 cycles
    cycles = sass.warp_cycles(m, 3 * 10 ** 6, 4)
    assert cycles == pytest.approx(31250 * 11)
    ms, by = sass.bound(12e6, cycles)
    assert by == "bytes" and ms == pytest.approx(12e6 / 3.35e12 * 1e3)
    ms, by = sass.bound(0, cycles)
    assert by == "operations"
    assert ms == pytest.approx(cycles / (4 * 132 * 1.98e9) * 1e3)
    with pytest.raises(LookupError):
        sass.find(_mixes(), "kernel")


@pytest.mark.parametrize("registers,warps", [(24, 64), (31, 64), (32, 64),
                                             (40, 48), (48, 40), (64, 32),
                                             (128, 16)])
def test_resident_warps(registers, warps):
    assert sass.resident_warps(registers) == warps
