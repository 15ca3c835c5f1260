"""attack.blocks_run_per_inner_step: the transformer blocks run, towers
(`blocks.vision`) and decoder (`blocks.llm`), forward and recomputation,
per inner step of the first outer step the program recorded: the program's
own counters."""

from vlabench.common.spans import per_inner_step


def read(rec):
    def blocks(step):
        c = step.counters
        return c["blocks.vision"] + c["blocks.llm"] if "blocks.vision" in c and "blocks.llm" in c else None

    return per_inner_step(blocks)
