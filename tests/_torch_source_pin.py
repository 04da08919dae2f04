"""Source comparison for the host modules the port copies from the JAX
package: a copy equals its original once blank lines, import lines and the
lines that name an original by ``file:line`` are dropped from both, the
port's package name is read as the original's, and a path into the
reference's checkout is read as the copy's "the reference's" (or "The
reference's" at the start of a sentence)."""
import re
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
_ORIGIN = re.compile(r'\.(py|cpp):\d+')
# an absolute path into the reference's checkout (the original's spelling)
# or "the reference's " (the copy's): both read as nothing
_REFERENCE = re.compile(r"(?<![\w./])/\w+/\w+/(?:restoration/)?|"
                        r"[Tt]he reference's ")


def normalised(path: str) -> list:
    """The lines of ``path`` (relative to the checkout) that must agree
    between a copy and its original."""
    out = []
    for line in (REPO / path).read_text().splitlines():
        s = line.strip()
        if (not s or s.startswith(('import ', 'from ')) or
                _ORIGIN.search(s)):
            continue
        out.append(_REFERENCE.sub('', line).replace('tpu_sgp_torch',
                                                    'tpu_sgp'))
    return out


def assert_copy_equal(copy: str, original: str, min_lines: int = 20) -> None:
    got, want = normalised(copy), normalised(original)
    assert len(got) > min_lines, f'{copy}: nothing left to compare'
    assert got == want, f'{copy} drifted from {original}'
