"""``python -m bcfl_tpu_torch.dist`` — one peer process of the dist
runtime."""

import sys

from bcfl_tpu_torch.dist.runtime import peer_main

if __name__ == "__main__":
    sys.exit(peer_main())
