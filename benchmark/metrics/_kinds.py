"""How the traced kernels divide among the layers: the substep kernels are
named ``substep_*`` (csrc/substep_kernel.cu's entry points), NCCL's carry
``nccl`` in their names, and every other kernel is a torch op's."""


def substep(name: str) -> bool:
    return name.startswith("substep_")


def nccl(name: str) -> bool:
    return "nccl" in name.lower()


def op(name: str) -> bool:
    return not substep(name) and not nccl(name)
