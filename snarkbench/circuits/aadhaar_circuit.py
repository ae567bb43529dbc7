"""Frozen copy of `icicle_snark_tpu_torch/setup/aadhaar_circuit.py`, the benchmark's input: a later change to the port's builders does not move the yardstick.

AadhaarVerifier — the full `benchmark/anon_aadhaar` circuit family.

Native rebuild of the reference's anon_aadhaar benchmark circuit
(the reference's benchmark/anon_aadhaar/circuit.circom AadhaarVerifier):

  * SignatureVerifier (helpers/signature.circom): dynamic-length SHA-256
    over the SHA-padded QR payload (helpers/rsa/sha.circom Sha256Bytes /
    Sha256General — all blocks hashed, final state selected by padded
    length), PKCS#1 v1.5 RSA-65537 verification (helpers/rsa/rsa.circom
    RSAVerify65537 + RSAPad — same DigestInfo prefix and modulus-sized
    0xff run as our `_rsa_verify_core`), Poseidon hash of the packed
    public key.
  * QRDataExtractor (helpers/extractor.circom): nDelimitedData
    construction (each 255 delimiter replaced by n*255 with the photo
    region excluded), timestamp (fixed offsets 9..18 — V2 reference-ID
    layout), age-above-18, gender, state, pin code, photo extraction
    through barrel-shift SubarraySelectors (utils/array.circom).
  * Nullifier (helpers/nullifier.circom): Poseidon(3)(seed,
    Poseidon(16)(photo[0:16]), Poseidon(16)(photo[16:32])).

Divergence from the reference: RSA bigints use this framework's 64x32
limb split (rsa_circuit.py) instead of circom-bigint's 121x17 — same
verification semantics, different limb schedule. Everything else follows
the circom sources structurally; circom `assert`s (witness-time only,
no constraints) become Python asserts.

Public signals (snarkjs order — outputs, then declared public inputs):
  1 pubkeyHash, 2 nullifier, 3 timestamp, 4 ageAbove18, 5 gender,
  6 state, 7 pinCode, 8 nullifierSeed, 9 signalHash.
"""

from __future__ import annotations

import hashlib

from ..reference.field import R_MOD
from .r1cs import R1CS
from .rsa_circuit import (
    _SHA256_BASE_LEN,
    _SHA256_MSG_LEN,
    _SHA256_PREFIX,
    E,
    K,
    N_BITS,
    Big,
    _alloc_limbs,
    _gen_prime,
    _is_zero,
    _less_than,
    _num2bits,
    _rsa_verify_core,
    _split_limbs,
)
from .poseidon import poseidon_gadget, poseidon_hash
from .sha256_circuit import (
    _IV,
    Bit,
    Builder,
    _compress,
    _const_bit,
    _lc_add,
    _lc_scale,
)

PHOTO_PACK_SIZE = 32       # constants.circom photoPackSize()
MAX_FIELD_BYTES = 31       # pack.circom maxBytesInField()
IST_OFFSET = 19800
MAX_YEARS = 2032           # extractor.circom DigitBytesToTimestamp(2032)

# field positions (constants.circom)
DOB_POS, GENDER_POS, PINCODE_POS, STATE_POS, PHOTO_POS = 4, 5, 11, 13, 18


def _log2_circom(a: int) -> int:
    """array.circom log2(): smallest r with 2^(r-1) >= a (their quirk)."""
    n, r = 1, 1
    while n < a:
        r += 1
        n *= 2
    return r


def _ev_sum(pairs: list) -> tuple:
    lc, v = {}, 0
    for p_lc, p_v in pairs:
        lc = _lc_add(lc, p_lc)
        v += p_v
    return lc, v % R_MOD


# ------------------------------------------------------------------ gadgets


def _sha256_dynamic(bld: Builder, byte_sigs: list, byte_vals: list,
                    len_lc: dict, len_val: int) -> list:
    """Sha256Bytes(maxDataLength): hash every 64-byte block of the
    pre-padded input, select the state after block len/64. Returns the
    256 digest Bits as an MSB-first stream."""
    n = len(byte_sigs)
    assert n % 64 == 0
    max_blocks = n // 64

    # byte -> bit decomposition (Num2Bits(8) per byte, as sha.circom)
    stream = []  # MSB-first bit stream
    for s, v in zip(byte_sigs, byte_vals):
        ids = _num2bits(bld, {s: 1}, v, 8)  # LSB-first signal ids
        stream.extend(Bit({ids[7 - j]: 1}, (v >> (7 - j)) & 1) for j in range(8))

    def word(bits_msb):
        return list(reversed(bits_msb))  # internal layout is LSB-first

    state = [[_const_bit((v >> i) & 1) for i in range(32)] for v in _IV]
    states = []
    for b in range(max_blocks):
        block = [word(stream[b * 512 + i * 32 : b * 512 + (i + 1) * 32])
                 for i in range(16)]
        state = _compress(bld, state, block)
        states.append(state)

    # block-count selector: eq_b = (len == 64*(b+1)); exactly one must hit
    eqs = []
    for b in range(max_blocks):
        target = 64 * (b + 1)
        eqs.append(_is_zero(bld, _lc_add(len_lc, {0: -target % R_MOD}),
                            len_val - target))
    sum_lc, sum_v = _ev_sum([(e.lc, e.val) for e in eqs])
    bld.constrain(_lc_add(sum_lc, {0: R_MOD - 1}), {0: 1}, {})
    assert sum_v == 1, "padded length must be a whole number of blocks"

    # select digest words, then re-decompose to bits for the output order
    digest_bits = []
    for i in range(8):
        packed = []
        for b, eq in enumerate(eqs):
            w = states[b][i]
            w_lc, _ = _ev_sum([(_lc_scale(bit.lc, 1 << j), 0) for j, bit in enumerate(w)])
            w_v = sum(bit.val << j for j, bit in enumerate(w))
            prod = bld.mul(eq, Bit(w_lc, w_v))
            packed.append((prod.lc, prod.val))
        sel_lc, sel_v = _ev_sum(packed)
        ids = _num2bits(bld, sel_lc, sel_v, 32)
        digest_bits.extend(Bit({ids[31 - j]: 1}, (sel_v >> (31 - j)) & 1)
                           for j in range(32))
    return digest_bits


def _subarray_selector(bld: Builder, arr: list, start_lc, start_v,
                       length_lc, length_v, out_len: int) -> list:
    """array.circom SubarraySelector: barrel-rotate `arr` left by
    `start`, keep out_len entries, zero entries at index >= length."""
    max_len = len(arr)
    bits = _log2_circom(max_len)
    assert max_len <= (1 << bits) and out_len <= max_len
    idx_ids = _num2bits(bld, start_lc, start_v, bits)
    cur = [(dict(lc), v) for lc, v in arr]
    for j in range(bits):
        bit = Bit({idx_ids[j]: 1}, (start_v >> j) & 1)
        nxt = []
        for i in range(max_len):
            off = (i + (1 << j)) % max_len
            diff_lc = _lc_add(cur[off][0], _lc_scale(cur[i][0], -1))
            diff_v = cur[off][1] - cur[i][1]
            prod = bld.mul(bit, Bit(diff_lc, diff_v))
            nxt.append((_lc_add(prod.lc, cur[i][0]), (prod.val + cur[i][1]) % R_MOD))
        cur = nxt
    out = []
    for i in range(out_len):
        gt = _less_than(bld, {0: i}, i, length_lc, length_v, bits)  # i < length
        prod = bld.mul(gt, Bit(cur[i][0], cur[i][1]))
        out.append((prod.lc, prod.val))
    return out


def _array_selector(bld: Builder, arr: list, idx_lc, idx_v, bits: int) -> tuple:
    """array.circom ArraySelector: eq-scan select arr[idx]."""
    max_len = len(arr)
    lt = _less_than(bld, idx_lc, idx_v, {0: max_len}, max_len, bits)
    bld.constrain(_lc_add(lt.lc, {0: R_MOD - 1}), {0: 1}, {})
    assert lt.val == 1
    terms = []
    for i, (lc, v) in enumerate(arr):
        eq = _is_zero(bld, _lc_add(idx_lc, {0: -i % R_MOD}), idx_v - i)
        prod = bld.mul(eq, Bit(lc, v))
        terms.append((prod.lc, prod.val))
    return _ev_sum(terms)


def _digit_bytes_to_number(items: list) -> tuple:
    """pack.circom DigitBytesToNumber: linear Horner over ASCII digits."""
    lc, v = {}, 0
    for b_lc, b_v in items:
        assert 48 <= b_v <= 57, "non-digit byte in numeric field"
        lc = _lc_add(_lc_scale(lc, 10), _lc_add(b_lc, {0: -48 % R_MOD}))
        v = v * 10 + (b_v - 48)
    return lc, v


def _bytes_to_int_chunks(items: list, n_chunks: int) -> list:
    """pack.circom BytesToIntChunks: little-endian 31-byte packing
    (linear). Missing tail bytes pack as zero."""
    out = []
    for i in range(n_chunks):
        chunk = items[i * MAX_FIELD_BYTES : (i + 1) * MAX_FIELD_BYTES]
        lc, v = {}, 0
        for j, (b_lc, b_v) in enumerate(chunk):
            lc = _lc_add(lc, _lc_scale(b_lc, 1 << (8 * j)))
            v += b_v << (8 * j)
        out.append((lc, v % R_MOD))
    return out


_DAYS_TILL_MONTH = [0, 31, 59, 90, 120, 151, 181, 212, 243, 273, 304, 334]


def _digits_to_timestamp(bld: Builder, year, month, day, hour) -> tuple:
    """extractor.circom DigitBytesToTimestamp(2032) with minute=second=0.
    year/month/day/hour are (lc, value) pairs."""
    y_lc, y_v = year
    m_lc, m_v = month
    d_lc, d_v = day
    h_lc, h_v = hour
    assert 1970 <= y_v <= MAX_YEARS
    max_leap = (MAX_YEARS - 1972) // 4

    days = [(_lc_scale(y_lc, 365), (y_v - 1970) * 365, -1970 * 365),
            (d_lc, d_v - 1, -1)]
    # (lc, int value, const offset) — fold offsets into lc via signal 0
    parts = []
    for lc, v, off in days:
        parts.append((_lc_add(lc, {0: off % R_MOD}), v))
    for i in range(12):
        eq = _is_zero(bld, _lc_add(m_lc, {0: -(i + 1) % R_MOD}), m_v - (i + 1))
        parts.append((_lc_scale(eq.lc, _DAYS_TILL_MONTH[i]),
                      eq.val * _DAYS_TILL_MONTH[i]))
    after_feb = _less_than(bld, {0: 2}, 2, m_lc, m_v, 4)  # month > 2
    for i in range(max_leap):
        # year-1972 > 4i  <=>  4i < year-1972
        y72_lc, y72_v = _lc_add(y_lc, {0: -1972 % R_MOD}), y_v - 1972
        gt = _less_than(bld, {0: 4 * i}, 4 * i, y72_lc, y72_v, 8)
        parts.append((gt.lc, gt.val))
        eq = _is_zero(bld, _lc_add(y72_lc, {0: -(4 * i) % R_MOD}), y72_v - 4 * i)
        prod = bld.mul(eq, after_feb)
        parts.append((prod.lc, prod.val))
    total_lc, total_v = _ev_sum(parts)
    out_lc = _lc_add(_lc_scale(total_lc, 86400), _lc_scale(h_lc, 3600))
    out_v = (total_v * 86400 + h_v * 3600) % R_MOD
    return out_lc, out_v


# ------------------------------------------------------------ main circuit


def aadhaar_verifier_circuit(qr_data_padded: bytes, padded_len: int,
                             non_padded_len: int, delimiter_indices: list,
                             signature: int, modulus: int,
                             nullifier_seed: int, signal_hash: int,
                             reveal: tuple = (1, 1, 1, 1)) -> tuple:
    """Build the AadhaarVerifier R1CS + witness. Returns (r1cs, witness).

    qr_data_padded: full buffer (maxDataLength bytes, SHA padding
    included up to padded_len). The constraint structure depends only on
    len(qr_data_padded)."""
    max_len = len(qr_data_padded)
    assert max_len % 64 == 0 and padded_len % 64 == 0
    n_pub = 9
    bld = Builder(n_public=n_pub)
    SIG_PUBKEY_HASH, SIG_NULLIFIER, SIG_TIMESTAMP = 1, 2, 3
    SIG_AGE, SIG_GENDER, SIG_STATE, SIG_PINCODE = 4, 5, 6, 7
    SIG_SEED, SIG_SIGNAL = 8, 9
    bld.values[SIG_SEED] = nullifier_seed % R_MOD
    bld.values[SIG_SIGNAL] = signal_hash % R_MOD

    # private inputs
    data_sigs = [bld.alloc(b) for b in qr_data_padded]
    data_vals = list(qr_data_padded)
    len_sig = bld.alloc(padded_len)
    nonpad_sig = bld.alloc(non_padded_len)
    delim_sigs = [bld.alloc(d) for d in delimiter_indices]
    assert len(delim_sigs) == 18
    sig_big = _alloc_limbs(bld, _split_limbs(signature))
    mod_big = _alloc_limbs(bld, _split_limbs(modulus), range_check=False)
    reveal_sigs = [bld.alloc(r) for r in reveal]

    # ---- SignatureVerifier: SHA-256 (dynamic blocks) + RSA + pubkey hash
    digest = _sha256_dynamic(bld, data_sigs, data_vals, {len_sig: 1}, padded_len)
    em_low = [digest[8 * (31 - i // 8) + 7 - (i % 8)]
              for i in range(_SHA256_MSG_LEN)]
    _rsa_verify_core(bld, sig_big, mod_big, em_low, _SHA256_MSG_LEN,
                     _SHA256_BASE_LEN, _SHA256_PREFIX)

    pk_inputs = []
    for i in range(K // 2):
        lc = _lc_add(mod_big.lcs[2 * i],
                     _lc_scale(mod_big.lcs[2 * i + 1], 1 << N_BITS))
        v = (mod_big.ints[2 * i] + (mod_big.ints[2 * i + 1] << N_BITS)) % R_MOD
        pk_inputs.append((lc, v))
    pkh_lc, pkh_v = poseidon_gadget(bld, pk_inputs)
    bld.values[SIG_PUBKEY_HASH] = pkh_v
    bld.constrain(_lc_add(pkh_lc, {SIG_PUBKEY_HASH: R_MOD - 1}), {0: 1}, {})

    # ---- QRDataExtractor
    data = [({s: 1}, v) for s, v in zip(data_sigs, data_vals)]
    photo_delim_lc = {delim_sigs[PHOTO_POS - 1]: 1}
    photo_delim_v = delimiter_indices[PHOTO_POS - 1]
    n255 = ({}, 0)  # running count*255 of delimiters seen so far
    ndelim = []
    for i in range(max_len):
        is255 = _is_zero(bld, _lc_add(data[i][0], {0: -255 % R_MOD}),
                         data[i][1] - 255)
        before = _less_than(bld, {0: i}, i,
                            _lc_add(photo_delim_lc, {0: 1}), photo_delim_v + 1, 12)
        both = bld.mul(is255, before)
        bump = bld.mul(both, Bit(n255[0], n255[1]))
        ndelim.append((_lc_add(bump.lc, data[i][0]),
                       (bump.val + data[i][1]) % R_MOD))
        n255 = (_lc_add(_lc_scale(both.lc, 255), n255[0]),
                (both.val * 255 + n255[1]) % R_MOD)

    # timestamp (fixed V2 reference-ID offsets)
    year = _digit_bytes_to_number(ndelim[9:13])
    month = _digit_bytes_to_number(ndelim[13:15])
    day = _digit_bytes_to_number(ndelim[15:17])
    hour = _digit_bytes_to_number(ndelim[17:19])
    ts_lc, ts_v = _digits_to_timestamp(bld, year, month, day, hour)
    ts_lc = _lc_add(ts_lc, {0: -IST_OFFSET % R_MOD})
    ts_v = (ts_v - IST_OFFSET) % R_MOD
    bld.values[SIG_TIMESTAMP] = ts_v
    bld.constrain(_lc_add(ts_lc, {SIG_TIMESTAMP: R_MOD - 1}), {0: 1}, {})

    # age above 18 (AgeExtractor + GreaterThan(8))
    dob_start_lc = {delim_sigs[DOB_POS - 1]: 1}
    dob_start_v = delimiter_indices[DOB_POS - 1]
    shifted = _subarray_selector(bld, ndelim, dob_start_lc, dob_start_v,
                                 _lc_add(dob_start_lc, {0: 10}),
                                 dob_start_v + 10, 12)
    assert shifted[0][1] == DOB_POS * 255 and shifted[11][1] == (DOB_POS + 1) * 255
    bld.constrain(_lc_add(shifted[0][0], {0: -(DOB_POS * 255) % R_MOD}), {0: 1}, {})
    bld.constrain(_lc_add(shifted[11][0], {0: -((DOB_POS + 1) * 255) % R_MOD}),
                  {0: 1}, {})
    b_year = _digit_bytes_to_number(shifted[7:11])
    b_month = _digit_bytes_to_number(shifted[4:6])
    b_day = _digit_bytes_to_number(shifted[1:3])
    age_parts = [(_lc_add(year[0], _lc_scale(b_year[0], -1)),
                  (year[1] - b_year[1] - 1) % R_MOD)]
    age_parts[0] = (_lc_add(age_parts[0][0], {0: R_MOD - 1}), age_parts[0][1])
    m_gt = _less_than(bld, b_month[0], b_month[1],
                      _lc_add(month[0], {0: 1}), month[1] + 1, 4)
    d_gt = _less_than(bld, b_day[0], b_day[1],
                      _lc_add(day[0], {0: 1}), day[1] + 1, 4)
    age_lc, age_v = _ev_sum(age_parts + [(m_gt.lc, m_gt.val), (d_gt.lc, d_gt.val)])
    above18 = _less_than(bld, {0: 18}, 18, age_lc, age_v, 8)
    rev_age = bld.mul(Bit({reveal_sigs[0]: 1}, reveal[0]), above18)
    bld.values[SIG_AGE] = rev_age.val
    bld.constrain(_lc_add(rev_age.lc, {SIG_AGE: R_MOD - 1}), {0: 1}, {})

    # gender (three ArraySelectors)
    g_start_lc = {delim_sigs[GENDER_POS - 1]: 1}
    g_start_v = delimiter_indices[GENDER_POS - 1]
    sd, sd_v = _array_selector(bld, ndelim, g_start_lc, g_start_v, 16)
    bld.constrain(_lc_add(sd, {0: -(GENDER_POS * 255) % R_MOD}), {0: 1}, {})
    assert sd_v == GENDER_POS * 255
    ed, ed_v = _array_selector(bld, ndelim, _lc_add(g_start_lc, {0: 2}),
                               g_start_v + 2, 16)
    bld.constrain(_lc_add(ed, {0: -((GENDER_POS + 1) * 255) % R_MOD}), {0: 1}, {})
    assert ed_v == (GENDER_POS + 1) * 255
    g_lc, g_v = _array_selector(bld, ndelim, _lc_add(g_start_lc, {0: 1}),
                                g_start_v + 1, 16)
    assert g_v < 255
    rev_g = bld.mul(Bit({reveal_sigs[1]: 1}, reveal[1]), Bit(g_lc, g_v))
    bld.values[SIG_GENDER] = rev_g.val
    bld.constrain(_lc_add(rev_g.lc, {SIG_GENDER: R_MOD - 1}), {0: 1}, {})

    # state (ExtractAndPackAsInt at STATE_POS)
    st_start_lc = {delim_sigs[STATE_POS - 1]: 1}
    st_start_v = delimiter_indices[STATE_POS - 1]
    st_end_lc = {delim_sigs[STATE_POS]: 1}
    st_end_v = delimiter_indices[STATE_POS]
    st_bytes = _subarray_selector(
        bld, ndelim, st_start_lc, st_start_v,
        _lc_add(st_end_lc, _lc_scale(st_start_lc, -1)),
        st_end_v - st_start_v, MAX_FIELD_BYTES + 1)
    assert st_bytes[0][1] == STATE_POS * 255
    bld.constrain(_lc_add(st_bytes[0][0], {0: -(STATE_POS * 255) % R_MOD}),
                  {0: 1}, {})
    st_end_val, st_end_val_v = _array_selector(bld, ndelim, st_end_lc, st_end_v, 16)
    bld.constrain(_lc_add(st_end_val, {0: -((STATE_POS + 1) * 255) % R_MOD}),
                  {0: 1}, {})
    assert st_end_val_v == (STATE_POS + 1) * 255
    assert all(v < 255 for _, v in st_bytes[1:])
    st_int = _bytes_to_int_chunks(st_bytes[1:], 1)[0]
    rev_st = bld.mul(Bit({reveal_sigs[2]: 1}, reveal[2]), Bit(*st_int))
    bld.values[SIG_STATE] = rev_st.val
    bld.constrain(_lc_add(rev_st.lc, {SIG_STATE: R_MOD - 1}), {0: 1}, {})

    # pin code (PinCodeExtractor)
    pc_start_lc = {delim_sigs[PINCODE_POS - 1]: 1}
    pc_start_v = delimiter_indices[PINCODE_POS - 1]
    pc_end_lc = {delim_sigs[PINCODE_POS]: 1}
    pc_end_v = delimiter_indices[PINCODE_POS]
    pc_bytes = _subarray_selector(
        bld, ndelim, pc_start_lc, pc_start_v,
        _lc_add(_lc_add(pc_end_lc, _lc_scale(pc_start_lc, -1)), {0: 1}),
        pc_end_v - pc_start_v + 1, 8)
    assert pc_bytes[0][1] == PINCODE_POS * 255
    assert pc_bytes[7][1] == (PINCODE_POS + 1) * 255
    bld.constrain(_lc_add(pc_bytes[0][0], {0: -(PINCODE_POS * 255) % R_MOD}),
                  {0: 1}, {})
    bld.constrain(_lc_add(pc_bytes[7][0], {0: -((PINCODE_POS + 1) * 255) % R_MOD}),
                  {0: 1}, {})
    pc_lc, pc_v = _digit_bytes_to_number(pc_bytes[1:7])
    rev_pc = bld.mul(Bit({reveal_sigs[3]: 1}, reveal[3]), Bit(pc_lc, pc_v))
    bld.values[SIG_PINCODE] = rev_pc.val
    bld.constrain(_lc_add(rev_pc.lc, {SIG_PINCODE: R_MOD - 1}), {0: 1}, {})

    # photo (PhotoExtractor) — pack size fixed at 32 ints; for reduced
    # maxDataLength builds the selector width shrinks and missing tail
    # bytes pack as zero (same nullifier once data fits)
    ph_start_lc = {delim_sigs[PHOTO_POS - 1]: 1}
    ph_start_v = delimiter_indices[PHOTO_POS - 1]
    photo_bytes_len = min(PHOTO_PACK_SIZE * MAX_FIELD_BYTES + 1, max_len)
    ph_bytes = _subarray_selector(
        bld, ndelim, ph_start_lc, ph_start_v,
        _lc_add(_lc_add({nonpad_sig: 1}, _lc_scale(ph_start_lc, -1)), {}),
        non_padded_len - ph_start_v, photo_bytes_len)
    assert ph_bytes[0][1] == PHOTO_POS * 255
    bld.constrain(_lc_add(ph_bytes[0][0], {0: -(PHOTO_POS * 255) % R_MOD}),
                  {0: 1}, {})
    n_avail = (photo_bytes_len - 1 + MAX_FIELD_BYTES - 1) // MAX_FIELD_BYTES
    photo_ints = _bytes_to_int_chunks(ph_bytes[1:], n_avail)
    photo_ints += [({}, 0)] * (PHOTO_PACK_SIZE - n_avail)

    # nullifier
    h1 = poseidon_gadget(bld, photo_ints[:16])
    h2 = poseidon_gadget(bld, photo_ints[16:])
    null_lc, null_v = poseidon_gadget(
        bld, [({SIG_SEED: 1}, nullifier_seed % R_MOD), h1, h2])
    bld.values[SIG_NULLIFIER] = null_v
    bld.constrain(_lc_add(null_lc, {SIG_NULLIFIER: R_MOD - 1}), {0: 1}, {})

    # dummy square binding signalHash
    sq = bld.alloc(signal_hash * signal_hash % R_MOD)
    bld.constrain({SIG_SIGNAL: 1}, {SIG_SIGNAL: 1}, {sq: 1})

    r1cs = R1CS(n_vars=len(bld.values), n_public=n_pub)
    r1cs.constraints = bld.constraints
    assert all(v is not None for v in bld.values)
    return r1cs, bld.values


# ------------------------------------------------------------ test vector


def _sign_pkcs1_sha256(digest: bytes, n: int, d: int) -> int:
    h = int.from_bytes(digest, "big")
    em = h | (_SHA256_PREFIX << _SHA256_MSG_LEN)
    for i in range(_SHA256_BASE_LEN + 8, n.bit_length() - 15):
        em |= 1 << i
    return pow(em, d, n)


def aadhaar_test_vector(max_data_length: int = 1536, photo_len: int = 64,
                        nullifier_seed: int = 12345678,
                        signal_hash: int = 1):
    """Synthetic Aadhaar V2 QR payload signed with the deterministic
    test RSA key. Returns (kwargs for aadhaar_verifier_circuit,
    expected public outputs dict)."""
    p = _gen_prime(1024, 1)
    q = _gen_prime(1024, 2)
    n = p * q
    d = pow(E, -1, (p - 1) * (q - 1))

    fields = {
        1: b"3",                          # email+mobile indicator
        2: b"1234" + b"20240115093015",   # refid: last4 + YYYYMMDDHHMMSS
        3: b"JOHN DOE",
        4: b"01-06-1990",                 # DOB DD-MM-YYYY
        5: b"M",
        6: b"CARE OF",
        7: b"DISTRICT",
        8: b"LANDMARK",
        9: b"12",
        10: b"LOCATION",
        11: b"110051",                    # pin code
        12: b"POST OFFICE",
        13: b"DELHI",                     # state
        14: b"STREET",
        15: b"SUBDISTRICT",
        16: b"VTC",
        17: b"5678",                      # mobile last 4
    }
    data = bytearray(b"V2")
    delims = []
    for pos in range(1, 19):
        delims.append(len(data))
        data.append(255)
        if pos <= 17:
            data += fields[pos]
    photo = bytes((7 * i + 3) % 255 for i in range(photo_len))
    data += photo
    non_padded_len = len(data)
    digest = hashlib.sha256(bytes(data)).digest()

    # SHA padding in-buffer (qrDataPadded is the padded message)
    data.append(0x80)
    while (len(data) + 8) % 64:
        data.append(0)
    data += (non_padded_len * 8).to_bytes(8, "big")
    padded_len = len(data)
    assert padded_len <= max_data_length, "payload exceeds maxDataLength"
    data += bytes(max_data_length - padded_len)

    signature = _sign_pkcs1_sha256(digest, n, d)

    # expected outputs (host-side recomputation)
    mod_limbs = _split_limbs(n)
    pk_inputs = [mod_limbs[2 * i] + (mod_limbs[2 * i + 1] << N_BITS)
                 for i in range(K // 2)]
    photo_padded = photo + bytes(PHOTO_PACK_SIZE * MAX_FIELD_BYTES - len(photo))
    photo_ints = [int.from_bytes(
        photo_padded[i * MAX_FIELD_BYTES:(i + 1) * MAX_FIELD_BYTES], "little")
        for i in range(PHOTO_PACK_SIZE)]
    import calendar
    ts = calendar.timegm((2024, 1, 15, 9, 0, 0)) - IST_OFFSET
    # month_gt: current_month+1 > dob_month (1+1 > 6 false -> 0);
    # day_gt: current_day+1 > dob_day (15+1 > 1 -> 1)
    age = 2024 - 1990 - 1 + 0 + 1
    expected = {
        "pubkeyHash": poseidon_hash(pk_inputs),
        "nullifier": poseidon_hash([
            nullifier_seed,
            poseidon_hash(photo_ints[:16]),
            poseidon_hash(photo_ints[16:]),
        ]),
        "timestamp": ts,
        "ageAbove18": int(age > 18),
        "gender": ord("M"),
        "state": int.from_bytes(b"DELHI" + bytes(MAX_FIELD_BYTES - 5), "little"),
        "pinCode": 110051,
    }
    kwargs = dict(
        qr_data_padded=bytes(data), padded_len=padded_len,
        non_padded_len=non_padded_len, delimiter_indices=delims,
        signature=signature, modulus=n, nullifier_seed=nullifier_seed,
        signal_hash=signal_hash,
    )
    return kwargs, expected
