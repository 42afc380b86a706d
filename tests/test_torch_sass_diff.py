"""tools/sass_diff.py's reading of `cuobjdump -sass`: one entry per
function, its instruction lines only, and a kernel named by exactly one
function."""

import pytest

from alphagomoku_tpu_torch.tools import sass_diff as T

SASS = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_117score_scan_kernelILi16EEEvPKi
\t.headerflags\t@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;      /* 0x00000a00ff017b82 */
                                                               /* 0x000fe40000000800 */
        /*0010*/                   EXIT ;                      /* 0x000000000000794d */
\t\t..........

\t\tFunction : _ZN12_GLOBAL__N_117score_scan_kernelILi32EEEvPKi
        /*0000*/                   EXIT ;                      /* 0x000000000000794d */
"""


def test_functions_keeps_each_functions_instructions():
    funcs = T.functions(SASS)
    assert list(funcs) == ["_ZN12_GLOBAL__N_117score_scan_kernelILi16EEEvPKi",
                           "_ZN12_GLOBAL__N_117score_scan_kernelILi32EEEvPKi"]
    first = funcs["_ZN12_GLOBAL__N_117score_scan_kernelILi16EEEvPKi"]
    assert len(first) == 2 and first[0].startswith("/*0000*/") and "EXIT" in first[1]


def test_pick_needs_exactly_one_function():
    funcs = T.functions(SASS)
    assert T.pick(funcs, "score_scan_kernelILi32E")[1] == funcs[
        "_ZN12_GLOBAL__N_117score_scan_kernelILi32EEEvPKi"]
    for part in ("score_scan_kernelILi", "score_backup_kernel"):
        with pytest.raises(SystemExit):
            T.pick(funcs, part)
