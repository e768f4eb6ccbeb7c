"""Host milliseconds per compress call in the engine and codecs layer,
from the program's spans in the traced run: the self time of its
`density.engine.*` spans, the encode of each batch (`engine.encode`):
its copy-free plan (`engine.plan`), the fixed point's masked plans
(`engine.plan_masked`) and FSM replays (`engine.fsm`) and the masked
assembly (`engine.assemble`), less the waits inside them."""

from portbench import spans


def read(ctx):
    return spans.layer_ms(ctx, "compress", "engine")
