// The paper's ten activations, selected by id in the kernels' epilogues.
//
// Ids follow repro_torch.core.activations.ACTIVATION_ORDER (sorted names):
//   0 elu, 1 gelu, 2 hardshrink, 3 identity, 4 leaky_relu, 5 mish, 6 relu,
//   7 selu, 8 sigmoid, 9 tanh.
// Definitions match the plain versions: exact gelu x/2·erfc(−x/√2) (the
// erfc form keeps the negative tail, where 1 + erf cancels), leaky slope 0.01,
// hardshrink λ=0.5 with strict inequalities, mish = x·tanh(softplus(x)) with
// softplus(x) = max(x, 0) + log1p(exp(-|x|)).  Full-precision libm calls
// (no fast-math): the kernels are checked against the plain versions at
// rtol 1e-4 / atol 1e-5.
#pragma once

#include <math.h>

__device__ __forceinline__ float apply_act(int id, float x) {
  switch (id) {
    case 0:  // elu
      return x > 0.f ? x : expm1f(x);
    case 1:  // gelu (exact)
      return 0.5f * x * erfcf(-x * 0.70710678118654752440f);
    case 2:  // hardshrink
      return (x > 0.5f || x < -0.5f) ? x : 0.f;
    case 3:  // identity
      return x;
    case 4:  // leaky_relu
      return x >= 0.f ? x : 0.01f * x;
    case 5: {  // mish
      const float sp = fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
      return x * tanhf(sp);
    }
    case 6:  // relu
      return x > 0.f ? x : 0.f;
    case 7:  // selu
      return 1.0507009873554804934f *
             (x > 0.f ? x : 1.6732632423543772848f * expm1f(x));
    case 8:  // sigmoid
      return 1.f / (1.f + expf(-x));
    case 9:  // tanh
      return tanhf(x);
    default:  // unknown id: poison the output rather than guess
      return __int_as_float(0x7fc00000);
  }
}

// The derivative act'(x), with JAX's values at the kinks (its jax.vjp at
// ones): relu'(0) = 0, leaky_relu'(0) = 1 (the x >= 0 branch), elu'(0) = 1
// and selu'(0) = scale·alpha (the x > 0 branch is strict), hardshrink'(±0.5)
// = 0 (strict inequalities).  mish' takes d softplus/dx = exp(x − softplus),
// the derivative JAX's logaddexp gives.  Matches
// repro_torch.core.activations.ACTIVATION_DERIVS.
__device__ __forceinline__ float apply_act_deriv(int id, float x) {
  switch (id) {
    case 0:  // elu
      return x > 0.f ? 1.f : expf(x);
    case 1:  // gelu (exact)
      return 0.5f * erfcf(-x * 0.70710678118654752440f) +
             x * expf(-0.5f * x * x) * 0.39894228040143267794f;
    case 2:  // hardshrink
      return (x > 0.5f || x < -0.5f) ? 1.f : 0.f;
    case 3:  // identity
      return 1.f;
    case 4:  // leaky_relu
      return x >= 0.f ? 1.f : 0.01f;
    case 5: {  // mish
      const float sp = fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
      const float t = tanhf(sp);
      return t + x * (1.f - t * t) * expf(x - sp);
    }
    case 6:  // relu
      return x > 0.f ? 1.f : 0.f;
    case 7:  // selu
      return x > 0.f ? 1.0507009873554804934f
                     : 1.0507009873554804934f * 1.6732632423543772848f *
                           expf(x);
    case 8: {  // sigmoid
      const float s = 1.f / (1.f + expf(-x));
      return s * (1.f - s);
    }
    case 9: {  // tanh
      const float t = tanhf(x);
      return 1.f - t * t;
    }
    default:  // unknown id: poison the output rather than guess
      return __int_as_float(0x7fc00000);
  }
}
