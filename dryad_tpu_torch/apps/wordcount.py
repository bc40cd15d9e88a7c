"""WordCount — BASELINE.md config 1, on the PyTorch port.

SelectMany(split) -> GroupBy(word) -> Count, as a query: tokenize ->
group_by count.  Same signatures as ``dryad_tpu/apps/wordcount.py``.
"""

from __future__ import annotations

from typing import Sequence

from dryad_tpu_torch.api.dataset import Context, Dataset

__all__ = ["wordcount_query", "wordcount"]


def wordcount_query(ds: Dataset, column: str = "line",
                    tokens_per_partition: int = 1 << 16,
                    max_token_len: int = 24, lower: bool = True,
                    max_tokens_per_row: int | None = 24) -> Dataset:
    # the per-row token bound shrinks the tokenizer's slot grid for
    # prose-shaped lines; pathological rows feed the NEED retry channel
    return (ds.split_words(column, out_capacity=tokens_per_partition,
                           max_token_len=max_token_len, lower=lower,
                           max_tokens_per_row=max_tokens_per_row)
              .group_by([column], {"n": ("count", None)}))


def wordcount(ctx: Context, lines: Sequence[bytes | str],
              max_line_len: int = 256, **kw):
    ds = ctx.from_columns({"line": list(lines)}, str_max_len=max_line_len)
    return wordcount_query(ds, **kw).collect()
