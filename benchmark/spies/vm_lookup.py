"""The VM lookup's bytes and flops by its definition (``counts/vm.py``), at
each query of a TensoRF field."""

from benchmark.counts import vm

TARGET = ("unboundednerfpytorch_tpu_torch.fields.grids", "vm_query")


def wrap(orig, spies):
    def vm_query(n01, f_vec, tables):
        with spies.counting():
            spies.add("vm_lookup", vm.lookup_work(
                n01.numel() // 3, [t.shape[-1] for t in tables[:3]],
                1 if f_vec is None else f_vec.shape[-1], tables[0].element_size()))
        return orig(n01, f_vec, tables)

    return vm_query
