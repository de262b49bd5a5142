"""A cell at a size a CPU test run holds: the configuration's options
with every width cut (tests only; the benchmark runs the files as they
are)."""

TINY = {"data.image_size": [32, 32], "SDF.Hash_config.n_levels": 4,
        "SDF.Hash_config.log2_hashmap_size": 12, "SDF.arch.layers": [None, 16, 8],
        "RadF.arch.layers": [None, 16, 16, 3], "SDF.VolSDF.sample_intvs": 16,
        "SDF.VolSDF.iters_max_st": 10, "Renderer.rand_rays": 512,
        "Renderer.compact_samples": 8, "Renderer.occ_res": 16}
#: the hard scene at its own 200 px: the two-view pose needs the pixels
TINY_HARD = dict(TINY, **{"data.image_size": [200, 200]})
#: a seed whose cuts read like the card's runs of the full cells
SEED = 123456789012


def edits(cell):
    return TINY_HARD if cell.startswith("synthhard") else TINY
