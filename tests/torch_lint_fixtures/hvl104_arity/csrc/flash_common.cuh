// HVL104 trigger fixture (a wrong arity): the dispatch.
#define HVD_FLASH_CASE(code, T, W, dtype, head_dim, FN, ...) \
  if ((dtype) == code && (head_dim) == W) return FN<T, W>(__VA_ARGS__)
#define HVD_FLASH_DISPATCH(dtype, head_dim, FN, ...)                   \
  do {                                                                 \
    HVD_FLASH_CASE(0, float, 64, dtype, head_dim, FN, __VA_ARGS__);    \
    HVD_FLASH_CASE(0, float, 128, dtype, head_dim, FN, __VA_ARGS__);   \
    HVD_FLASH_CASE(1, ns::bf16, 64, dtype, head_dim, FN, __VA_ARGS__); \
    HVD_FLASH_CASE(1, ns::bf16, 128, dtype, head_dim, FN, __VA_ARGS__); \
    return 1;                                                          \
  } while (0)
