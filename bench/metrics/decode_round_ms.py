"""decode_round_ms: device ms of a decode round, CUDA events around each
call of ``runtime/executor/vstep.py`` ``VStep.round`` (a graph replay,
or the reference variant beyond one dead shard) that began in the
window, averaged over them. Layer: executor round."""
from harness import readers

UNIT = "ms"
install = readers.install_round
read = readers.round_ms_mean
