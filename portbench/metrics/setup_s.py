"""setup_s: from the process's start to the window's first substep: the
imports, the kernel's build, build_model, the inputs, the warm-up chunk.
The host copies kept for the output check are left out."""


def read(record):
    if not record.get("on_card"):
        return None
    return record["setup_s"]
