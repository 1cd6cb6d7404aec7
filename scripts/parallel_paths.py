"""Paths (v) and (w) of ``chip_smoke.py`` alone, on one NVIDIA GPU:
the kernels' build, the flash case at the Llama call (the full-head times
(v) prints beside its head-shard call), path (k) (whose peak memory (v)
is held to), then (w), sequence parallelism, and (v), tensor parallelism
(``chip_smoke.py`` runs (v) first; here a failing gate of (v) leaves (w)'s
readings standing).

    python3 scripts/parallel_paths.py      # from the repository's root

About 100 s on an H100 with the build; every gate of the two paths
raises as in ``chip_smoke.py``.
"""
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from bcfl_tpu_torch.ops import codec_kernels as ck  # noqa: E402
from bcfl_tpu_torch.ops import cuda_build, registry  # noqa: E402
from bcfl_tpu_torch.ops import flash_kernels as fk  # noqa: E402



def main() -> int:
    if not torch.cuda.is_available():
        print("parallel_paths: no CUDA device", file=sys.stderr)
        return 2
    smi = cs.nvidia_smi_line()
    print(smi, flush=True)
    print(torch.__version__, torch.version.cuda, flush=True)
    stats = {op.name: cs.KernelStats(op) for op in registry.kernel_ops()}
    t0 = time.perf_counter()
    cuda_build.build_all()
    print("build", time.perf_counter() - t0, flush=True)
    dataset = cs.write_long_docs()
    llama_lens = cs.main_padding(dataset, cs.llama_config(dataset))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4321)
    llama_per = cs.flash_case(fk, stats, gen, "llama-path", 8, 32, 512, 512,
                              128, torch.bfloat16, True, llama_lens,
                              cs.LLAMA_ITERS, neg=-1e30)
    k_peak = cs.path_llama_cohort(ck, fk, stats, smi, dataset, llama_per)
    print("k done", time.perf_counter() - t0, flush=True)
    cs.path_sp(stats, smi, cs.write_long4k_docs())
    print("w done", time.perf_counter() - t0, flush=True)
    cs.path_tp(fk, stats, smi, dataset, llama_per, k_peak)
    print("v done", time.perf_counter() - t0, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
