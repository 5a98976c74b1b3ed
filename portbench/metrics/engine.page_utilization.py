"""Page Utilization of the last window's reads as the pool lays them out
after its collect: their bytes over the bytes of the pages their slots
lie on (page_slots records a page), from the final object table."""


def read(rec):
    return rec["page_utilization"]
