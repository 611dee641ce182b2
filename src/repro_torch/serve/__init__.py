from repro_torch.serve.engine import (AsyncServeEngine, Request,  # noqa: F401
                                      ServeEngine, greedy_sample,
                                      init_caches, make_decode_step,
                                      make_prefill_step)
from repro_torch.serve.kvcache import (BlockTable, PageError,  # noqa: F401
                                       PagePool)
from repro_torch.serve.scheduler import (SLO, RequestScheduler,  # noqa: F401
                                         ServeRequest)
