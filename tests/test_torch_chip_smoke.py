"""``chip_smoke.py``'s reading of the kernel names that ``ptxas -v`` and
``cuobjdump -sass`` print.

The build phase counts every instantiation of each kernel by its name.
nvcc names a kernel in an anonymous namespace inside a component
``_GLOBAL__N__<hash>_<n>_<file>_cu_<hash>`` whose hashes follow the source's
path, so the digits in them change from checkout to checkout. The name is
read component by component from the start, so that no such digit is taken
for the length of the kernel's name.
"""

import importlib.util
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _ns(file: str, first: str, second: str) -> str:
    part = f"_GLOBAL__N__{first}_{len(file)}_{file}_{second}"
    return f"{len(part)}{part}"


NAMES = {
    "bwd_dkv": ("_ZN" + _ns("flash_bwd_cu", "1676fa2f", "eec07c68")
                + "25flash_bwd_dkv_bf16_kernelILb1ELb0EEEvNS_6ParamsENS_4SegsE",
                "flash_bwd_dkv_bf16_kernel<1,0>"),
    # "25" in the hash is the length of "abc20flash_ring_q8_kernel"
    "hash_digits_spell_a_length": (
        "_ZN" + _ns("flash_ring_cu", "abcdef01", "dea25abc")
        + "20flash_ring_q8_kernelILb1ELb1EEEvNS_6ParamsE", "flash_ring_q8_kernel<1,1>"),
    "hash_digits_before_file": (
        "_ZN" + _ns("flash_ring_remote_cu", "a1b248cd", "0f0f0f0f")
        + "27flash_ring_remote_q8_kernelILb0EEEvNS_6ParamsE", "flash_ring_remote_q8_kernel<0>"),
    "int_template_args": ("_ZN" + _ns("flash_fwd_cu", "12345678", "9abcdef0")
                          + "20flash_fwd_f32_kernelILi64ELb0ELb1EEEvNS_6ParamsE",
                          "flash_fwd_f32_kernel<64,0,1>"),
    "nested_namespace": ("_ZN12_GLOBAL__N_12q815sweep_q8_kernelILi64EEEvv", "sweep_q8_kernel<64>"),
    "global_scope": ("_Z15q8_probe_kernelPKaS0_Pi", "q8_probe_kernel"),
    "global_template": ("_Z16decode_q8_kernelILi16EEvv", "decode_q8_kernel<16>"),
    "not_a_kernel": ("_ZN" + _ns("flash_bwd_cu", "1676fa2f", "eec07c68") + "10some_helperEv", None),
    "not_mangled": ("decode_split_kernel", None),
}


@pytest.mark.parametrize("case", sorted(NAMES))
def test_kernel_name_reads_the_mangled_name(case):
    mangled, want = NAMES[case]
    smoke = _chip_smoke()
    assert smoke._kernel_name(mangled, with_args=True) == (want or mangled)
    if want is not None:
        assert smoke._kernel_name(mangled) == want.split("<")[0]


def test_ptxas_usage_names_each_entry():
    smoke = _chip_smoke()
    mangled = NAMES["hash_digits_spell_a_length"][0]
    log = (f"ptxas info    : Compiling entry function '{mangled}' for 'sm_90a'\n"
           f"ptxas info    : Function properties for {mangled}\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
           "ptxas info    : Used 253 registers, used 16 barriers\n")
    assert smoke._ptxas_usage(log) == [
        "flash_ring_q8_kernel<1,1>: Used 253 registers, used 16 barriers"]
