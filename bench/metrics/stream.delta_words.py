"""Words of the pending delta (``StreamingIndex.delta_words``) as each
traced request started, as a mean."""


def read(run, prof):
    xs = run.layer.get("delta_words")
    if not xs:
        return None
    return sum(xs) / len(xs)
