// HVL104 clean fixture: the C side of a kernel ABI.
#include "flash_common.cuh"

extern "C" int hvd_kern(int dtype, int head_dim, const void* x, void* y,
                        int n, float scale, void* stream) {
  HVD_FLASH_DISPATCH(dtype, head_dim, launch, x, y, n, scale, stream);
}

extern "C" int hvd_kern_info(int dtype, int head_dim, int* info) {
  HVD_FLASH_DISPATCH(dtype, head_dim, info_of, info);
}
