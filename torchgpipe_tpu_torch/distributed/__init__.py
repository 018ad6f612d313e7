"""Multi-process (MPMD) pipeline parallelism.

Counterpart of ``torchgpipe_tpu/distributed`` (the fork's
``torchgpipe.distributed``): one pipeline stage per rank over a pluggable
transport, a mailbox of named channels per worker, and a rank-aware
data loader.
"""

from torchgpipe_tpu_torch.distributed.context import (  # noqa: F401
    LocalTransport,
    Mailbox,
    PeerDiedError,
    TcpTransport,
    worker,
)
from torchgpipe_tpu_torch.distributed.gpipe import (  # noqa: F401
    DistributedGPipe,
    DistributedGPipeDataLoader,
)
