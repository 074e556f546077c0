"""Zero findings: rule-shaped text in strings and comments is inert.

The threshold below is inside a string literal; the os.replace and the
.item() are in comments; the allow() syntax inside a string must NOT parse
as a suppression (and therefore must NOT raise unused-suppression either).
"""

DOC = """
The peel threshold is 2.0 * (1.0 + eps) * rho, a checkpoint published
with os.replace(tmp, final) would be torn-write unsafe, and x.item() syncs.
"""

HOWTO = "# repro: allow(atomic-io) this is a string, not a comment"

# A comment mentioning open(path, "w"), os.fsync(fd) and t.cpu() is not a call.


def documented(x: int) -> int:
    """pow2_bucket(n, 64) in a docstring is prose, not a call site."""
    return x
