"""GF(256) octet arithmetic tables (RFC 6330 s5.7.3).

The field is GF(2^8) with primitive polynomial x^8 + x^4 + x^3 + x^2 + 1
(0x11D) and generator alpha = 2.  All tables are *computed* from the
polynomial at import; the first entries are asserted against the normative
values printed in the RFC.

Reference parity: the oblas OCT_EXP / OCT_LOG / OCT_INV tables consumed at
lib/precode.c:69-76,303 (oblas itself is an unvendored submodule).

Exports:
- OCT_EXP[0..509]: alpha^i (doubled so log-domain sums need no mod 255)
- OCT_LOG[0..255]: discrete log (OCT_LOG[0] is a 0 sentinel, never valid)
- OCT_INV[0..255]: multiplicative inverse (OCT_INV[0] sentinel 0)
- GF_MUL[256,256]: full product table, the workhorse for host-side NumPy
- MUL_LO/MUL_HI[256,16]: nibble decomposition tables (16-entry lookups):
  a (x) b = MUL_LO[b, a & 15] ^ MUL_HI[b, a >> 4]
"""

import numpy as np

_POLY = 0x11D

_exp = np.zeros(510, dtype=np.uint8)
_log = np.zeros(256, dtype=np.uint8)
x = 1
for i in range(255):
    _exp[i] = x
    _log[x] = i
    x <<= 1
    if x & 0x100:
        x ^= _POLY
_exp[255:510] = _exp[0:255]

OCT_EXP = _exp
OCT_LOG = _log

# spot-check against RFC 6330 s5.7.3 normative table prefix
assert list(OCT_EXP[:10]) == [1, 2, 4, 8, 16, 32, 64, 128, 29, 58]
assert OCT_EXP[255] == 1 and OCT_LOG[142] == 254

_inv = np.zeros(256, dtype=np.uint8)
_inv[1:] = OCT_EXP[255 - OCT_LOG[np.arange(1, 256)].astype(np.int32)]
OCT_INV = _inv

# Full multiplication table: GF_MUL[a, b] = a (x) b.
_a = np.arange(256, dtype=np.int32)
_lg = OCT_LOG.astype(np.int32)
GF_MUL = OCT_EXP[(_lg[_a][:, None] + _lg[_a][None, :])].copy()
GF_MUL[0, :] = 0
GF_MUL[:, 0] = 0

# Nibble LUTs: for scalar beta, multiply a whole byte row by
# looking up low/high nibbles in two 16-entry tables.
MUL_LO = GF_MUL[:16, :].T.copy()  # MUL_LO[beta, lo] = lo (x) beta
_hi_vals = (np.arange(16, dtype=np.int32) << 4).astype(np.uint8)
MUL_HI = GF_MUL[_hi_vals, :].T.copy()  # MUL_HI[beta, hi] = (hi<<4) (x) beta

for t in (OCT_EXP, OCT_LOG, OCT_INV, GF_MUL, MUL_LO, MUL_HI):
    t.flags.writeable = False
