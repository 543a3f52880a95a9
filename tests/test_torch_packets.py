"""The port's DNoC packet formats and TCAM multicast routing
(``repro_torch.core.packets``, paper Fig. 4-6) against the reference's,
on the same seeded packets and tables: flit words, round trips, first
match routing one key at a time and in batches, the self-test and the
population key layout."""
import numpy as np
import pytest

from repro.core import packets as jp

from repro_torch.core import packets as tp


def _packets(rng, n):
    out = []
    for _ in range(n):
        bits = int(rng.choice([0, 32, 128]))
        out.append(dict(
            ptype=int(rng.integers(0, 3)), key=int(rng.integers(0, 2**32)),
            payload=(int.from_bytes(rng.bytes(16), "little")
                     % (1 << max(bits, 1))),
            payload_bits=bits, emergency=bool(rng.integers(0, 2)),
            timestamp=int(rng.integers(0, 4))))
    return out


def test_pack_unpack_match_the_reference():
    rng = np.random.default_rng(0)
    for kw in _packets(rng, 300):
        p = tp.Packet(ptype=tp.PacketType(kw["ptype"]),
                      **{k: v for k, v in kw.items() if k != "ptype"})
        q = jp.Packet(ptype=jp.PacketType(kw["ptype"]),
                      **{k: v for k, v in kw.items() if k != "ptype"})
        word = tp.pack(p)
        assert word == jp.pack(q) and word < 1 << tp.FLIT_BITS
        assert tp.unpack(word) == p
        u = jp.unpack(word)
        assert (int(u.ptype), u.key, u.payload, u.payload_bits, u.emergency,
                u.timestamp) == (kw["ptype"], kw["key"], kw["payload"],
                                 kw["payload_bits"], kw["emergency"],
                                 kw["timestamp"])
    assert tp.FLIT_BITS == jp.FLIT_BITS == 192
    assert tp.MAX_PAYLOAD_BITS == jp.MAX_PAYLOAD_BITS


def test_packet_rejects_what_the_format_cannot_hold():
    with pytest.raises(AssertionError):
        tp.Packet(tp.PacketType.MULTICAST, key=1 << 32)
    with pytest.raises(AssertionError):
        tp.Packet(tp.PacketType.MULTICAST, key=1, payload_bits=64)


def _tables(rng, n_entries, n_ports):
    tt, jt = tp.TcamTable.empty(n_ports), jp.TcamTable.empty(n_ports)
    for _ in range(n_entries):
        mask = int(rng.integers(0, 2**32)) & ~int(rng.integers(0, 2**32))
        key = int(rng.integers(0, 2**32)) & mask
        ports = rng.random(n_ports) < 0.4
        tt, jt = tt.add(key, mask, ports), jt.add(key, mask, ports)
    return tt, jt


@pytest.mark.parametrize("n_entries,n_ports", [(1, 3), (8, 6), (40, 18)])
def test_tcam_routes_like_the_reference(n_entries, n_ports):
    rng = np.random.default_rng(n_entries)
    tt, jt = _tables(rng, n_entries, n_ports)
    np.testing.assert_array_equal(tt.keys, jt.keys)
    np.testing.assert_array_equal(tt.masks, jt.masks)
    np.testing.assert_array_equal(tt.dests, jt.dests)
    keys = np.concatenate([tt.keys, rng.integers(0, 2**32, 500)]).astype(
        np.uint32)
    np.testing.assert_array_equal(tt.route_batch(keys), jt.route_batch(keys))
    for k in keys[:100]:
        a, b = tt.route(int(k)), jt.route(int(k))
        assert (a is None and b is None) or np.array_equal(a, b)
    assert tt.self_test() == jt.self_test()


def test_tcam_self_test_finds_a_malformed_entry():
    t = tp.TcamTable.empty(2).add(0x0F, 0xFF, [0])
    assert t.self_test()
    bad = tp.TcamTable.empty(2).add(0x1F0, 0xFF, [1])   # key bits off-mask
    assert not bad.self_test() and not jp.TcamTable.empty(2).add(
        0x1F0, 0xFF, [1]).self_test()


def test_population_key_layout():
    rng = np.random.default_rng(5)
    for x, y, c, p in rng.integers(0, 300, (50, 4)):
        assert tp.population_key(x, y, c, p) == jp.population_key(x, y, c, p)
