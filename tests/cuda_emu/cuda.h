// A host stand-in for CUDA's low-level cuda.h: the types of a TMA tensor
// map and of cuTensorMapEncodeTiled, whose emulated body (emu_encode_tiled,
// reached through cudaGetDriverEntryPoint in cuda_runtime.h) records the map
// for the emulated cp.async.bulk.tensor.
#pragma once
#include <cstdint>
#include <cstring>

typedef uint32_t cuuint32_t;
typedef uint64_t cuuint64_t;
typedef int CUresult;
enum { CUDA_SUCCESS = 0, CUDA_ERROR_INVALID_VALUE = 1 };
typedef enum { CU_TENSOR_MAP_DATA_TYPE_UINT8 = 0, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 = 9,
               CU_TENSOR_MAP_DATA_TYPE_FLOAT32 = 7 } CUtensorMapDataType;
typedef enum { CU_TENSOR_MAP_INTERLEAVE_NONE = 0 } CUtensorMapInterleave;
typedef enum { CU_TENSOR_MAP_SWIZZLE_NONE = 0, CU_TENSOR_MAP_SWIZZLE_64B = 2,
               CU_TENSOR_MAP_SWIZZLE_128B = 3 } CUtensorMapSwizzle;
typedef enum { CU_TENSOR_MAP_L2_PROMOTION_NONE = 0, CU_TENSOR_MAP_L2_PROMOTION_L2_128B = 2 }
    CUtensorMapL2promotion;
typedef enum { CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE = 0 } CUtensorMapFloatOOBfill;

// The map's fields as the encode call was given them (the real one is 128
// opaque bytes).
struct alignas(64) CUtensorMap {
  const unsigned char* base;
  int rank, elem_bytes, swizzle;
  uint64_t dims[5], strides[5];  // strides[i]: bytes between steps of dimension i + 1
  uint32_t box[5];
};

// A bit per rank of the maps encoded since emu_tensor_map_ranks last read it.
inline unsigned emu_map_ranks = 0;

inline int emu_elem_bytes(CUtensorMapDataType type) {
  return type == CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 ? 2 : type == CU_TENSOR_MAP_DATA_TYPE_FLOAT32 ? 4 : 1;
}

// cuTensorMapEncodeTiled: checks what the emulated copies rely on (element
// strides of 1, 16-byte aligned base and strides, a box row of at most 128
// bytes under the 128-byte swizzle and 64 under the 64-byte one) and
// records the map.
inline CUresult emu_encode_tiled(CUtensorMap* map, CUtensorMapDataType type, cuuint32_t rank,
                                 void* base, const cuuint64_t* dims, const cuuint64_t* strides,
                                 const cuuint32_t* box, const cuuint32_t* elem_strides,
                                 CUtensorMapInterleave, CUtensorMapSwizzle swizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill) {
  if (rank < 1 || rank > 5 || reinterpret_cast<uintptr_t>(base) % 16) return CUDA_ERROR_INVALID_VALUE;
  emu_map_ranks |= 1u << rank;
  std::memset(map, 0, sizeof(*map));
  map->base = static_cast<const unsigned char*>(base);
  map->rank = (int)rank;
  map->elem_bytes = emu_elem_bytes(type);
  map->swizzle = (int)swizzle;
  for (cuuint32_t i = 0; i < rank; ++i) {
    if (elem_strides[i] != 1 || box[i] < 1 || box[i] > 256) return CUDA_ERROR_INVALID_VALUE;
    map->dims[i] = dims[i];
    map->box[i] = box[i];
    if (i + 1 < rank) {
      if (strides[i] % 16) return CUDA_ERROR_INVALID_VALUE;
      map->strides[i] = strides[i];
    }
  }
  if (swizzle == CU_TENSOR_MAP_SWIZZLE_128B && box[0] * map->elem_bytes > 128)
    return CUDA_ERROR_INVALID_VALUE;
  if (swizzle == CU_TENSOR_MAP_SWIZZLE_64B && box[0] * map->elem_bytes > 64)
    return CUDA_ERROR_INVALID_VALUE;
  return CUDA_SUCCESS;
}
