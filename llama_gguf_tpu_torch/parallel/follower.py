"""Entry point of a mesh rank that rank 0 spawned (parallel/service.py):

    python -m llama_gguf_tpu_torch.parallel.follower SPEC_JSON

A module of its own, so that the child imports only the package, never the
parent's ``__main__``."""

import json
import sys


def main(argv=None) -> int:
    from .service import follower_main

    argv = sys.argv[1:] if argv is None else argv
    return follower_main(json.loads(argv[0]))


if __name__ == "__main__":
    sys.exit(main())
