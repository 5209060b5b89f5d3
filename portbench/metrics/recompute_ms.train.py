"""``recompute_ms.train``: GEMM backward: device ms of the kernels launched
inside the program's ``matmul.recompute`` spans (the fp32 pre-activation
product and the epilogue's derivative in ``_EngineGemm.backward``), per
profiled step."""
from harness import program_spans as P


def read(record):
    found = P.traced(record)
    if found is None or not found[0]["kernels"]:
        return None
    prof, spans = found
    recomputes = P.named(spans, "matmul.recompute")
    if not recomputes:
        return None
    return 1e3 * P.kernel_seconds(prof, recomputes) / record["profile_steps"]
