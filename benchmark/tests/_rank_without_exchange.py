"""A rank whose cross-rank exchange is left out: every ``all_reduce`` of
the program's collectives returns the rank's own buffer (the fault the
four-chip cell's check must catch).  Run by ``ranks.spawn`` in place of
``benchmark.harness.ranks``."""
import json
import sys

from opendog_tpu_torch.parallel import collectives

from benchmark.harness import ranks


def _no_exchange(what, buf, mesh):
    collectives.TRAFFIC[(what, buf.dtype, buf.numel())] += 1


collectives._all_reduce = _no_exchange

if __name__ == "__main__":
    sys.exit(ranks.main(json.loads(sys.argv[1])))
