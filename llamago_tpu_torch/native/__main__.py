"""`python -m llamago_tpu_torch.native --build` — (re)build build/libggjt-<hash>.so."""

import sys

from llamago_tpu_torch.native import available, build, lib_path

force = "--build" in sys.argv or "--force" in sys.argv
ok = build(force=force)
print(f"native data-path library: built={ok} available={available()} ({lib_path()})")
sys.exit(0 if ok or available() else 1)
