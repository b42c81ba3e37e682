"""The device trace's arithmetic: busy time, idle gaps, kernel names."""

import devtrace


def test_busy_time_is_the_union_and_gaps_what_it_leaves():
    busy, gaps = devtrace.busy_and_gaps([(5, 8), (2, 4), (3, 6), (12, 15)], 0, 20)
    assert busy == (8 - 2) + (15 - 12)
    assert gaps == [(0, 2), (8, 12), (15, 20)]
    assert devtrace.busy_and_gaps([], 0, 7) == (0, [(0, 7)])


def test_kernel_names_are_shortened_to_their_identifier():
    assert devtrace.short_name(
        "void (anonymous namespace)::flash_fwd<__nv_bfloat16, 80, (Mask)0>(CUtensorMap, int)"
    ) == "flash_fwd"
    assert devtrace.short_name("void at::native::elementwise_kernel<128, 2>(int, F)") == \
        "elementwise_kernel"
    assert devtrace.short_name("Memcpy HtoD (Pageable -> Device)") == "Memcpy HtoD"


def test_count_matches_by_pattern():
    k = [("void flash_fwd<a>(b)", 0.5), ("void patch_replace_kernel(x)", 0.25),
         ("void flash_fwd<c>(d)", 0.5)]
    assert devtrace.count(k, r"\bflash_fwd\b") == (2, 1.0)
