"""Mean per request of the wall time of ``transcribe`` outside its synced
stages (encode, ctc, prepare, align, and the LLM decoder's prefill and
generation of every attempt, a retry's too): audio load, the reporter,
hotwords, prompt assembly and the glue between the stages."""

STAGES = ("encode", "ctc", "prepare", "align")


def read(ctx):
    rows = [(r["wall_s"] - r["llm_s"] - sum(r["timings"][k] for k in STAGES))
            * 1e3 for r in ctx["records"] if r["ok"]]
    return sum(rows) / len(rows) if rows else None
